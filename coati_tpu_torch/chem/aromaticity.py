"""RDKit-model aromaticity perception for the in-tree Mol type.

The port's own copy of coati_tpu/chem/aromaticity.py: the same code and the
same results, importing nothing of the JAX package.

The reference runs every molecule through rdkit, whose DEFAULT
aromaticity model re-perceives aromatic systems on parse — so a
kekulized writing and an aromatic writing of one molecule are the same
molecule to the whole reference stack (canon_smiles unification,
containers/rdkit_utils.py:82; Crippen/QED typing on the perceived
graph; aromatic-ring descriptor counts). This module reproduces that
model offline:

Electron contributions (RDKit book, "The RDKit Aromaticity Model"):
  ring double bond (partner inside the tested ring set)        -> 1
  exocyclic double bond to an electronegative atom (N,O,S,...) -> 0
  exocyclic double bond to carbon                              -> atom
       is not a candidate (fulvene-type systems stay aliphatic)
  3-connected neutral N/P/As lone pair (pyrrole)               -> 2
  2-connected anionic N                                        -> 2
  2-connected neutral O/S/Se/Te (furan/thiophene)              -> 2
  carbanion / carbocation                                      -> 2 / 0
  3-connected neutral B (empty p orbital)                      -> 0
Candidates must be sp2-capable: total connections <= 3, no triple or
cumulated double bonds, element in {B,C,N,O,P,S,Se,Te,As}.

Hueckel 4n+2 is applied to every SSSR ring AND to every connected
union of fused rings (so azulene/indole perimeters aromatize even when
an individual ring's kekule double bond points into its neighbor).

`perceive_aromaticity` mutates in place: bond orders are kekulized,
then aromatic flags are set per the model, and aromatic non-carbon
atoms with hydrogens get an explicit hcount (so the written form is
`[nH]`, never a bare `n` that would re-parse as pyridine-type).
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Set, Tuple

from coati_tpu_torch.chem.descriptors import sssr_rings
from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import Mol, kekulize

__all__ = ["perceive_aromaticity"]

_ALLOWED = {"B", "C", "N", "O", "P", "S", "Se", "Te", "As"}
_ELECTRONEG = {"N", "O", "S", "Se", "Te"}

# per-atom status
_NONCAND = -1  # can never sit in an aromatic ring
_RING_DBL = -2  # contributes 1 iff its double-bond partner is in the set

# Systems with more rings than this get only per-ring + whole-system
# Hueckel tests instead of the full subset enumeration (2^n guard).
_MAX_ENUM_RINGS = 10


def _atom_status(
    mol: Mol,
    i: int,
    conn: int,
    dbl: List[Tuple[int, int]],
    has_triple: bool,
    ring_bonds: Set[int],
) -> Tuple[int, int]:
    """(status, partner): status is _NONCAND, _RING_DBL (partner = the
    double-bond partner atom), or the lone-pair electron count 0/2."""
    a = mol.atoms[i]
    if a.element not in _ALLOWED or has_triple or conn > 3 or len(dbl) > 1:
        return _NONCAND, -1
    if len(dbl) == 1:
        j, bi = dbl[0]
        if bi in ring_bonds:
            return _RING_DBL, j
        # exocyclic double bond
        if mol.atoms[j].element in _ELECTRONEG:
            return 0, -1
        return _NONCAND, -1
    e, c = a.element, a.charge
    if e == "C":
        if c == -1:
            return 2, -1
        if c == 1:
            return 0, -1
        return _NONCAND, -1
    if e in ("N", "P", "As"):
        if c == 0 and conn == 3:
            return 2, -1
        if c == -1 and conn == 2:
            return 2, -1
        return _NONCAND, -1
    if e in ("O", "S", "Se", "Te"):
        if c == 0 and conn == 2:
            return 2, -1
        return _NONCAND, -1
    if e == "B" and c == 0 and conn == 3:
        return 0, -1
    return _NONCAND, -1


def perceive_aromaticity(mol: Mol) -> None:
    """Kekulize, then set atom/bond aromatic flags per the RDKit default
    model (idempotent: re-perceiving a perceived molecule is a no-op on
    the flags)."""
    kekulize(mol)
    rings = sssr_rings(mol)
    if not rings:
        return
    ring_bonds: Set[int] = set().union(*rings)
    ring_atom_sets: List[Set[int]] = []
    for ring in rings:
        atoms: Set[int] = set()
        for bi in ring:
            atoms.add(mol.bonds[bi].a)
            atoms.add(mol.bonds[bi].b)
        ring_atom_sets.append(atoms)

    imp_h = implicit_hydrogens(mol)
    n = len(mol.atoms)
    degree = [0] * n
    dbl: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
    triple = [False] * n
    for bi, b in enumerate(mol.bonds):
        degree[b.a] += 1
        degree[b.b] += 1
        if b.order == 2:
            dbl[b.a].append((b.b, bi))
            dbl[b.b].append((b.a, bi))
        elif b.order >= 3:
            triple[b.a] = triple[b.b] = True

    status: Dict[int, Tuple[int, int]] = {}
    for atoms in ring_atom_sets:
        for i in atoms:
            if i not in status:
                status[i] = _atom_status(
                    mol, i, degree[i] + imp_h[i], dbl[i], triple[i],
                    ring_bonds,
                )

    def huckel(atom_set: Set[int]) -> bool:
        total = 0
        for i in atom_set:
            st, partner = status[i]
            if st == _NONCAND:
                return False
            if st == _RING_DBL:
                if partner not in atom_set:
                    return False  # kekule double bond leaves the set
                total += 1
            else:
                total += st
        return total >= 2 and (total - 2) % 4 == 0

    # fused-ring systems (rings sharing at least one bond)
    parent = list(range(len(rings)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in combinations(range(len(rings)), 2):
        if rings[i] & rings[j]:
            parent[find(i)] = find(j)
    systems: Dict[int, List[int]] = {}
    for r in range(len(rings)):
        systems.setdefault(find(r), []).append(r)

    arom_atoms: Set[int] = set()
    arom_bonds: Set[int] = set()

    def try_subset(subset: Tuple[int, ...]) -> None:
        atom_set: Set[int] = set()
        for r in subset:
            atom_set |= ring_atom_sets[r]
        if huckel(atom_set):
            arom_atoms.update(atom_set)
            for r in subset:
                arom_bonds.update(rings[r])

    for members in systems.values():
        if len(members) <= _MAX_ENUM_RINGS:
            # all connected subsets: grown breadth-first from each ring
            # (size-1 first so single aromatic rings always mark)
            ring_adj: Dict[int, List[int]] = {r: [] for r in members}
            for i, j in combinations(members, 2):
                if rings[i] & rings[j]:
                    ring_adj[i].append(j)
                    ring_adj[j].append(i)
            seen_subsets: Set[Tuple[int, ...]] = set()
            frontier: List[Tuple[int, ...]] = [(r,) for r in members]
            while frontier:
                sub = frontier.pop(0)
                if sub in seen_subsets:
                    continue
                seen_subsets.add(sub)
                try_subset(sub)
                in_sub = set(sub)
                grow = {
                    nb for r in sub for nb in ring_adj[r] if nb not in in_sub
                }
                for nb in grow:
                    frontier.append(tuple(sorted(in_sub | {nb})))
        else:
            for r in members:
                try_subset((r,))
            try_subset(tuple(members))

    for i in arom_atoms:
        a = mol.atoms[i]
        a.aromatic = True
        # explicit hcount so the aromatic writing survives a round trip
        # ([nH] pyrrole vs bare n pyridine)
        if a.element != "C" and a.hcount is None and imp_h[i] > 0:
            a.hcount = imp_h[i]
    for bi in arom_bonds:
        mol.bonds[bi].aromatic = True
