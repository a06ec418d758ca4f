"""Molecular descriptors via the in-tree parser (no RDKit).

The port's own copy of coati_tpu/chem/descriptors.py: the same code and the
same results, importing nothing of the JAX package.

Offline substitute for the descriptor block of the reference's
mol_properties (containers/rdkit_utils.py:249-265) and the COATI2
property-conditioning source coati2_properties (data/xform_coati2.py).
MolLogP and QED live in chem/crippen.py and chem/qed.py (they need the
SMARTS matcher, chem/smarts.py); everything else is computed here.

Definitions used (documented because pattern-based RDKit counts can
differ at the margin; a gated test asserts agreement when rdkit is
importable):
- MolWt / ExactMolWt: standard atomic weights from the shipped
  periodic table / monoisotopic masses for the common elements.
- TPSA: Ertl 2000 N/O fragment contributions (the RDKit default —
  no S/P terms). Classification runs on the graph as written
  (aromatic flags from lowercase form), like the rest of the in-tree
  chemistry. Verified against published values (aspirin 63.60,
  caffeine 58.44, ...) in coati_tpu's tests/test_descriptors.py.
- NumHDonors: N or O with >= 1 attached hydrogen.
- NumHAcceptors: N or O count, excluding pyrrole-type aromatic NH and
  amide/sulfonamide N (N single-bonded to a C=O/S=O), the dominant
  corrections to the raw Lipinski N+O rule.
- NumRotatableBonds: RDKit's non-strict pattern — single non-ring
  bond, both ends heavy-degree >= 2 and not in a triple bond.
- Ring counts: SSSR via shortest-cycle-per-bond + GF(2) greedy
  independence, size = cycle rank (bonds - atoms + components).
"""

from __future__ import annotations

from collections import deque
from functools import lru_cache
from typing import Dict, List, Optional, Set

from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import Mol, _bridges, parse_smiles

__all__ = ["molecular_descriptors", "tpsa", "sssr_rings"]

# monoisotopic masses for organic-chemistry elements; ExactMolWt falls
# back to the standard weight for anything rarer
_MONO = {
    "H": 1.007825, "B": 11.009305, "C": 12.0, "N": 14.003074,
    "O": 15.994915, "F": 18.998403, "Si": 27.976927, "P": 30.973762,
    "S": 31.972071, "Cl": 34.968853, "Br": 78.918338, "I": 126.904473,
    "Se": 79.916522, "As": 74.921596, "Te": 129.906223,
}

_AVG: dict = {}


def _avg_mass(symbol: str) -> float:
    if not _AVG:
        from coati_tpu_torch.common.periodic_table import PERIODIC_TABLE

        _AVG.update({e["symbol"]: float(e.get("atomic_mass") or 0.0)
                     for e in PERIODIC_TABLE})
    return _AVG.get(symbol, 0.0)


def sssr_rings(mol: Mol) -> List[Set[int]]:
    """Smallest set of smallest rings, as sets of BOND indices: for
    every cycle bond take the shortest cycle through it, then greedily
    keep a GF(2)-independent subset of size cycle-rank."""
    n = len(mol.atoms)
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for bi, b in enumerate(mol.bonds):
        adj[b.a].append((b.b, bi))
        adj[b.b].append((b.a, bi))
    bridges = _bridges(mol)
    frags = {a.frag for a in mol.atoms}
    rank = len(mol.bonds) - n + len(frags)
    if rank <= 0:
        return []
    candidates: List[Set[int]] = []
    seen_rings: Set[frozenset] = set()
    for bi, b in enumerate(mol.bonds):
        if bi in bridges:
            continue
        # shortest a->b path avoiding bond bi
        prev = {b.a: (-1, -1)}
        q = deque([b.a])
        while q and b.b not in prev:
            u = q.popleft()
            for v, ebi in adj[u]:
                if ebi == bi or v in prev:
                    continue
                prev[v] = (u, ebi)
                q.append(v)
        if b.b not in prev:
            continue
        ring = {bi}
        u = b.b
        while u != b.a:
            u, ebi = prev[u]
            ring.add(ebi)
        fr = frozenset(ring)
        if fr not in seen_rings:
            seen_rings.add(fr)
            candidates.append(ring)
    candidates.sort(key=len)
    basis: List[int] = []  # bitmask echelon
    chosen: List[Set[int]] = []
    for ring in candidates:
        vec = 0
        for bi in ring:
            vec |= 1 << bi
        # Gaussian elimination over GF(2): basis kept leading-bit sorted
        cur = vec
        for bm in basis:
            hi = bm.bit_length() - 1
            if (cur >> hi) & 1:
                cur ^= bm
        if cur:
            basis.append(cur)
            basis.sort(reverse=True)
            chosen.append(ring)
            if len(chosen) == rank:
                break
    return chosen


def _ring_atoms(mol: Mol, rings: List[Set[int]]) -> List[Set[int]]:
    out = []
    for ring in rings:
        atoms: Set[int] = set()
        for bi in ring:
            atoms.add(mol.bonds[bi].a)
            atoms.add(mol.bonds[bi].b)
        out.append(atoms)
    return out


# ------------------------------------------------------------------ TPSA

# Ertl 2000 fragment contributions for N and O (the RDKit default TPSA,
# which omits S/P terms). Keys: (element, charge, aromatic, n_H,
# signature of non-H bond orders sorted, in_3ring)
def _tpsa_contribution(
    elem: str, charge: int, aromatic: bool, n_h: int,
    orders: List[int], in_3ring: bool,
) -> float:
    key = tuple(sorted(orders))
    if elem == "N" and not aromatic:
        if charge == 0:
            if n_h == 0:
                if key == (1, 1, 1):
                    return 3.01 if in_3ring else 3.24
                if key == (1, 2):
                    return 12.36
                if key == (3,):
                    return 23.79
                if key == (1, 2, 2):
                    return 11.68
                if key == (2, 3):
                    return 13.60
            elif n_h == 1:
                if key == (1, 1):
                    return 21.94 if in_3ring else 12.03
                if key == (2,):
                    return 23.85
            elif n_h == 2:
                if key == (1,):
                    return 26.02
        elif charge == 1:
            if n_h == 0:
                if key == (1, 1, 1, 1):
                    return 0.00
                if key == (1, 1, 2):
                    return 3.01
                if key == (1, 3):
                    return 4.36
            elif n_h == 1:
                if key == (1, 1, 1):
                    return 4.44
                if key == (1, 2):
                    return 13.97
            elif n_h == 2:
                if key == (1, 1):
                    return 16.61
                if key == (2,):
                    return 25.59
            elif n_h == 3:
                if key == (1,):
                    return 27.64
    elif elem == "N" and aromatic:
        # aromatic ring bonds carry label 5 in `orders`
        n_ar = key.count(5)
        n_single = key.count(1)
        n_double = key.count(2)
        if charge == 0:
            if n_h == 0:
                if n_ar == 2 and len(key) == 2:
                    return 12.89
                if n_ar == 3 and len(key) == 3:
                    return 4.41
                if n_ar == 2 and n_single == 1:
                    return 4.93
                if n_ar == 2 and n_double == 1:
                    return 8.39
            elif n_h == 1 and n_ar == 2:
                return 15.79
        elif charge == 1:
            if n_h == 0:
                if n_ar == 3 and len(key) == 3:
                    return 4.10
                if n_ar == 2 and n_single == 1:
                    return 3.88
            elif n_h == 1 and n_ar == 2:
                return 14.14
    elif elem == "O" and not aromatic:
        if charge == 0:
            if n_h == 0:
                if key == (1, 1):
                    return 12.53 if in_3ring else 9.23
                if key == (2,):
                    return 17.07
            elif n_h == 1 and key == (1,):
                return 20.23
        elif charge == -1 and n_h == 0 and key == (1,):
            return 23.06
    elif elem == "O" and aromatic:
        if key.count(5) == 2 and charge == 0 and n_h == 0:
            return 13.14
    # unparameterized environment: Ertl assigns zero
    return 0.0


def tpsa(mol: Mol, hydrogens: Optional[List[int]] = None) -> float:
    h = hydrogens if hydrogens is not None else implicit_hydrogens(mol)
    rings = _ring_atoms(mol, [r for r in sssr_rings(mol) if len(r) == 3])
    three_ring = set().union(*rings) if rings else set()
    ladj: List[List[int]] = [[] for _ in mol.atoms]
    for b in mol.bonds:
        label = 5 if b.aromatic else b.order
        ladj[b.a].append(label)
        ladj[b.b].append(label)
    total = 0.0
    for a in mol.atoms:
        if a.element not in ("N", "O"):
            continue
        total += _tpsa_contribution(
            a.element, a.charge, a.aromatic, h[a.idx],
            ladj[a.idx], a.idx in three_ring,
        )
    return round(total, 2)


# ------------------------------------------------------------ descriptors


def molecular_descriptors(smiles: str) -> Dict[str, float]:
    """All in-tree-computable descriptors of the reference
    mol_properties / coati2_properties set. Raises EncoderError on
    unparseable SMILES. Returns a fresh dict per call (the cache holds
    an immutable snapshot, so caller mutation can't poison it)."""
    return dict(_cached_descriptors(smiles))


@lru_cache(maxsize=100_000)
def _cached_descriptors(smiles: str) -> tuple:
    # deferred import: aromaticity pulls sssr_rings from this module
    from coati_tpu_torch.chem.aromaticity import perceive_aromaticity

    mol = parse_smiles(smiles)
    # rdkit-model perception so a kekulized writing reports the same
    # TPSA / aromatic-ring counts / FractionCSP3 as the aromatic form
    perceive_aromaticity(mol)
    h = implicit_hydrogens(mol)
    n = len(mol.atoms)
    adj: List[List[tuple]] = [[] for _ in range(n)]
    for bi, b in enumerate(mol.bonds):
        adj[b.a].append((b.b, bi))
        adj[b.b].append((b.a, bi))

    mol_wt = sum(_avg_mass(a.element) + h[a.idx] * 1.008 for a in mol.atoms)
    exact_wt = sum(
        _MONO.get(a.element, _avg_mass(a.element)) + h[a.idx] * _MONO["H"]
        for a in mol.atoms
    )

    carbons = [a for a in mol.atoms if a.element == "C"]
    sp3 = 0
    for a in carbons:
        if a.aromatic:
            continue
        if all(mol.bonds[bi].order == 1 and not mol.bonds[bi].aromatic
               for _, bi in adj[a.idx]):
            sp3 += 1
    fraction_csp3 = sp3 / len(carbons) if carbons else 0.0

    rings = sssr_rings(mol)
    ring_atom_sets = _ring_atoms(mol, rings)
    ring_bonds_all: Set[int] = set().union(*rings) if rings else set()

    def ring_aromatic(ring: Set[int]) -> bool:
        return all(mol.bonds[bi].aromatic for bi in ring)

    def ring_saturated(ring: Set[int]) -> bool:
        return all(
            mol.bonds[bi].order == 1 and not mol.bonds[bi].aromatic
            for bi in ring
        )

    def ring_carbocycle(atoms: Set[int]) -> bool:
        return all(mol.atoms[i].element == "C" for i in atoms)

    num_aromatic = sum(ring_aromatic(r) for r in rings)
    num_aliphatic = sum(not ring_aromatic(r) for r in rings)
    num_saturated = sum(ring_saturated(r) for r in rings)
    num_arom_carbo = sum(
        ring_aromatic(r) and ring_carbocycle(atoms)
        for r, atoms in zip(rings, ring_atom_sets)
    )
    num_aliph_carbo = sum(
        (not ring_aromatic(r)) and ring_carbocycle(atoms)
        for r, atoms in zip(rings, ring_atom_sets)
    )

    # H-bond donors/acceptors
    donors = sum(
        1 for a in mol.atoms if a.element in ("N", "O") and h[a.idx] >= 1
    )
    carbonyl_c: Set[int] = set()
    for b in mol.bonds:
        if b.order == 2 and not b.aromatic:
            ea, eb = mol.atoms[b.a].element, mol.atoms[b.b].element
            if ea in ("C", "S") and eb == "O":
                carbonyl_c.add(b.a)
            if eb in ("C", "S") and ea == "O":
                carbonyl_c.add(b.b)
    acceptors = 0
    for a in mol.atoms:
        if a.element == "O":
            acceptors += 1
        elif a.element == "N":
            if a.aromatic and h[a.idx] >= 1:
                continue  # pyrrole-type NH
            if any(
                mol.bonds[bi].order == 1 and not mol.bonds[bi].aromatic
                and j in carbonyl_c
                for j, bi in adj[a.idx]
            ):
                continue  # amide / sulfonamide N
            acceptors += 1

    in_triple = set()
    for b in mol.bonds:
        if b.order == 3:
            in_triple.add(b.a)
            in_triple.add(b.b)
    rot = 0
    for bi, b in enumerate(mol.bonds):
        if b.order != 1 or b.aromatic or bi in ring_bonds_all:
            continue
        if len(adj[b.a]) < 2 or len(adj[b.b]) < 2:
            continue
        if b.a in in_triple or b.b in in_triple:
            continue
        rot += 1

    return tuple({
        "MolWt": round(mol_wt, 3),
        "ExactMolWt": round(exact_wt, 4),
        "TPSA": tpsa(mol, h),
        "FractionCSP3": round(fraction_csp3, 6),
        "HeavyAtomCount": n,
        "NumHeteroatoms": sum(1 for a in mol.atoms if a.element not in ("C", "H")),
        "NumHAcceptors": acceptors,
        "NumHDonors": donors,
        "NumRotatableBonds": rot,
        "RingCount": len(rings),
        "NumAromaticRings": num_aromatic,
        "NumAliphaticRings": num_aliphatic,
        "NumSaturatedRings": num_saturated,
        "NumAromaticCarbocycles": num_arom_carbo,
        "NumAliphaticCarbocycles": num_aliph_carbo,
    }.items())
