"""Distance-geometry 3D conformer embedding (ETKDG-lite, offline).

The port's own copy of coati_tpu/chem/conformers.py: the same code and the
same results, importing nothing of the JAX package.

The reference builds 3D inputs for the point encoder with RDKit's ETKDG
(containers/rdkit_utils.py:162-219 mol_to_atoms_coords -> EmbedMolecule
/ EmbedMultipleConfs; consumed by e3gnn via clip_ar_xform and
generative/coati_purifications.embed_points). Without rdkit that path
was dead — precomputed coordinate columns were the only 3D source.
This module is a from-scratch distance-geometry embedder over the
in-tree Mol type, the classical ETKDG skeleton:

  1. BOUNDS  — 1-2 from covalent-radius bond lengths (order-scaled),
     1-3 from ideal hybridization angles via the law of cosines
     (small-ring internal angles override), 1-4 cis/trans envelope,
     >=1-5 van-der-Waals lower bounds;
  2. SMOOTH  — iterative triangle-inequality smoothing of the bounds
     matrix (upper: u_ij <= u_ik + u_kj; lower: l_ij >= l_ik - u_kj);
  3. EMBED   — random metrization (distances sampled within bounds),
     classical MDS (double-centered Gram matrix, top-3 eigenvectors);
  4. REFINE  — gradient descent on squared bound violations plus a
     light planarity term for sp2 centers.

Stereochemistry IS embedded: tetrahedral @/@@ markers become signed-volume restraints on the
SMILES-ordered neighbor quadruple (OpenSMILES 3.9.2 written order —
the same `mol.written` + implicit-H-position algebra the canonical
writer's parity fixup uses, selfies_lite.write_smiles) enforced during
REFINE, and directional cis/trans markers pin the 1-4 bounds of every
substituent pair across the double bond to the torsion-formula cis or
trans distance instead of the free envelope. One honest caveat: the
absolute orientation convention ("@" == negative signed volume of the
ordered quadruple) is pinned by a gated rdkit test; offline, a global
convention flip is unobservable because it mirrors every molecule
whole — all pairwise distances, i.e. everything the EGNN consumes
(models/egnn.py), are invariant. Diastereomer geometry (relative
parity of multiple centers, cis vs trans) is convention-independent
and tested offline. MMFF94s optimization (reference optimize=True ->
MMFFOptimizeMoleculeConfs) is stood in by chem/forcefield.py: each DG
embedding is FIRE-relaxed under an MMFF-lite valence force field and
conformers are ranked by minimized energy; without optimize, the
refined DG stress remains the ranking surrogate.

Sanity is pinned by coati_tpu's tests/test_conformers.py: bond-length RMS vs the
table, angle sanity, no nonbonded clashes, E(3)-invariant EGNN
embeddings from the generated coords, and a gated rdkit-ETKDG
comparison when the package is importable.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import Mol, kekulize, parse_smiles

__all__ = ["embed_conformer", "embed_smiles_to_atoms_coords"]

# Covalent radii (Cordero 2008), Angstrom — enough for drug space;
# anything unlisted falls back to 0.75.
_COV_RADIUS: Dict[str, float] = {
    "H": 0.31, "B": 0.84, "C": 0.76, "N": 0.71, "O": 0.66, "F": 0.57,
    "Si": 1.11, "P": 1.07, "S": 1.05, "Cl": 1.02, "Ge": 1.20,
    "As": 1.19, "Se": 1.20, "Br": 1.20, "Sn": 1.39, "Sb": 1.39,
    "Te": 1.38, "I": 1.39,
}
# van der Waals radii (Bondi), Angstrom.
_VDW_RADIUS: Dict[str, float] = {
    "H": 1.10, "B": 1.92, "C": 1.70, "N": 1.55, "O": 1.52, "F": 1.47,
    "Si": 2.10, "P": 1.80, "S": 1.80, "Cl": 1.75, "As": 1.85,
    "Se": 1.90, "Br": 1.85, "Te": 2.06, "I": 1.98,
}
# bond-order length scaling (double/triple bonds contract).
_ORDER_SCALE = {1: 1.0, 2: 0.87, 3: 0.78}
_AROMATIC_SCALE = 0.925

_SP3_ANGLE = math.radians(109.471)
_SP2_ANGLE = math.radians(120.0)
_SP_ANGLE = math.radians(179.0)
# internal angles of small rings override hybridization
_RING_ANGLE = {3: math.radians(60.0), 4: math.radians(88.0),
               5: math.radians(104.0)}


def _cov(e: str) -> float:
    return _COV_RADIUS.get(e, 0.75)


def _vdw(e: str) -> float:
    return _VDW_RADIUS.get(e, 1.7)


def _bond_length(ea: str, eb: str, order: int, aromatic: bool) -> float:
    base = _cov(ea) + _cov(eb)
    if aromatic:
        return base * _AROMATIC_SCALE
    return base * _ORDER_SCALE.get(order, 1.0)


class _HGraph:
    """Hydrogen-augmented working graph: heavy atoms in parse order,
    then explicit hydrogens appended (rdkit AddHs layout)."""

    def __init__(self, mol: Mol, hydrogenate: bool):
        # capture aromatic flags BEFORE kekulizing: kekulize() clears
        # them while assigning alternating orders, and aromatic rings
        # must embed with uniform ~1.4 A bonds (0.925 scale), not the
        # kekulized 1.32/1.51 A alternation (ETKDG gives ~1.39 uniform)
        arom_atoms = [a.aromatic for a in mol.atoms]
        arom_bonds = [b.aromatic for b in mol.bonds]
        kekulize_safe(mol)
        n_heavy = len(mol.atoms)
        self.elem: List[str] = [a.element for a in mol.atoms]
        self.arom: List[bool] = arom_atoms
        self.z: List[int] = []
        edges: List[Tuple[int, int, int, bool]] = [
            (b.a, b.b, b.order, ar)
            for b, ar in zip(mol.bonds, arom_bonds)
        ]
        h_first: List[int] = [-1] * n_heavy
        if hydrogenate:
            h = implicit_hydrogens(mol)
            for i in range(n_heavy):
                for _ in range(h[i]):
                    j = len(self.elem)
                    if h_first[i] < 0:
                        h_first[i] = j
                    self.elem.append("H")
                    self.arom.append(False)
                    edges.append((i, j, 1, False))
        self.tetra, self.cistrans = _stereo_constraints(
            mol, h_first, arom_bonds)
        self.n = len(self.elem)
        self.edges = edges
        self.adj: List[List[Tuple[int, int, bool]]] = [[] for _ in range(self.n)]
        for a, b, order, ar in edges:
            self.adj[a].append((b, order, ar))
            self.adj[b].append((a, order, ar))
        from coati_tpu_torch.chem.fingerprints import _atomic_number

        self.z = [_atomic_number(e) for e in self.elem]
        # hybridization-ish angle per center
        self.angle: List[float] = []
        for i in range(self.n):
            orders = [o for _, o, _ in self.adj[i]]
            if self.arom[i]:
                self.angle.append(_SP2_ANGLE)
            elif any(o >= 3 for o in orders) or sum(o >= 2 for o in orders) >= 2:
                self.angle.append(_SP_ANGLE)
            elif any(o == 2 for o in orders):
                self.angle.append(_SP2_ANGLE)
            else:
                self.angle.append(_SP3_ANGLE)
        # smallest ring size through each atom (3..5 only; bounded BFS)
        self.ring_size = [0] * self.n
        for i in range(self.n):
            self.ring_size[i] = _smallest_ring(self.adj, i, cap=5)


def kekulize_safe(mol: Mol) -> None:
    kekulize(mol)


def _stereo_constraints(mol: Mol, h_first: List[int], arom_bonds: List[bool]):
    """Extract geometric stereo constraints from the parsed markers.

    Returns (tetra, cistrans):
      tetra    — [(center, (n1, n2, n3, n4), sign)] signed-volume
                 restraints. The quadruple is the OpenSMILES 3.9.2
                 written neighbor order (`mol.written`: preceding atom
                 first, then ring digits / branches in text order) with
                 the bracket implicit H inserted at position 0 when the
                 atom roots its fragment, else position 1 — the same
                 algebra as write_smiles' parity fixup
                 (selfies_lite.py:1041-1060). sign=-1 for "@" (looking
                 from n1 at the center, n2->n3->n4 anticlockwise =>
                 negative (n2-n1)x(n3-n1).(n4-n1) triple product),
                 +1 for "@@".
      cistrans — [(i, a, b, l, is_trans)] for every substituent pair
                 (i on a, l on b) across a stereo-marked non-aromatic
                 double bond a=b. Directional chars are normalized to
                 "read toward the double-bond atom" (flip on reversal,
                 the bond_char algebra); equal normalized chars on both
                 ends mean the substituents rise toward their centers
                 from the same side => cis.
    Centers with fewer than four embedded neighbors (e.g. chiral
    sulfoxides, or hydrogenate=False dropping the bracket H) are
    skipped — documented scope, matching the EGNN's distance-only
    consumption."""
    roots = {node.atom for node in mol.roots}
    other = [(b.a, b.b) for b in mol.bonds]

    tetra = []
    for idx, a in enumerate(mol.atoms):
        if a.chirality not in ("@", "@@") or idx >= len(mol.written):
            continue
        nbrs = []
        for bi in mol.written[idx]:
            pa, pb = other[bi]
            nbrs.append(pb if pa == idx else pa)
        if (a.hcount or 0) == 1 and h_first[idx] >= 0:
            nbrs.insert(0 if idx in roots else 1, h_first[idx])
        if len(nbrs) != 4 or len(set(nbrs)) != 4:
            continue
        sign = -1.0 if a.chirality == "@" else 1.0
        tetra.append((idx, tuple(nbrs), sign))

    # per double-bond end: substituent -> side (+1/-1); the marked
    # substituent takes its normalized char's side, an unmarked sibling
    # the opposite side
    cistrans = []
    for bi, b in enumerate(mol.bonds):
        if b.order != 2 or arom_bonds[bi]:
            continue

        def _sides(center: int, skip_bi: int):
            sides = {}
            marked = None
            for bj, bd in enumerate(mol.bonds):
                if bj == skip_bi or bd.order != 1:
                    continue
                if bd.a == center:
                    sub = bd.b
                elif bd.b == center:
                    sub = bd.a
                else:
                    continue
                if bd.stereo:
                    # normalize to read sub -> center
                    ch = bd.stereo if (bd.a == sub) else (
                        "/" if bd.stereo == "\\" else "\\")
                    sides[sub] = 1 if ch == "/" else -1
                    marked = sub
                else:
                    sides.setdefault(sub, None)
            if marked is None:
                return None
            for sub, s in list(sides.items()):
                if s is None:
                    sides[sub] = -sides[marked]
            return sides

        sa = _sides(b.a, bi)
        sb = _sides(b.b, bi)
        if sa is None or sb is None:
            continue
        for i, si in sa.items():
            for l, sl in sb.items():
                cistrans.append((i, b.a, b.b, l, si != sl))
    return tetra, cistrans


def _smallest_ring(adj, root: int, cap: int) -> int:
    """Length of the smallest cycle through `root`, capped; 0 if none
    within the cap. BFS from root tracking the first edge taken."""
    best = 0
    # BFS: dist + first-neighbor tag; a meeting of two different first
    # edges at depth d1+d2 closes a cycle of d1+d2(+1)
    dist = {root: 0}
    first = {root: -1}
    q = [(root, -1)]
    qi = 0
    while qi < len(q):
        u, _ = q[qi]
        qi += 1
        if dist[u] >= (cap + 1) // 2 + 1:
            continue
        for v, _, _ in adj[u]:
            if v == root and dist[u] >= 2 and first.get(u, -2) != v:
                size = dist[u] + 1
                if size <= cap and (best == 0 or size < best):
                    best = size
            if v not in dist:
                dist[v] = dist[u] + 1
                first[v] = v if u == root else first[u]
                q.append((v, 0))
            elif first.get(v) != first.get(u) and v != root and u != root:
                size = dist[u] + dist[v] + 1
                if size <= cap and (best == 0 or size < best):
                    best = size
    return best


def _bounds(g: _HGraph) -> Tuple[np.ndarray, np.ndarray]:
    n = g.n
    BIG = 1000.0
    upper = np.full((n, n), BIG)
    lower = np.zeros((n, n))
    blen: Dict[Tuple[int, int], float] = {}
    for a, b, order, ar in g.edges:
        d = _bond_length(g.elem[a], g.elem[b], order, ar)
        blen[(a, b)] = blen[(b, a)] = d
        upper[a, b] = upper[b, a] = d * 1.01
        lower[a, b] = lower[b, a] = d * 0.99
    # 1-3: law of cosines at the center's ideal angle
    for j in range(n):
        nbrs = [v for v, _, _ in g.adj[j]]
        theta = g.angle[j]
        if g.ring_size[j] in _RING_ANGLE:
            theta_ring = _RING_ANGLE[g.ring_size[j]]
        else:
            theta_ring = None
        for x in range(len(nbrs)):
            for y in range(x + 1, len(nbrs)):
                i, k = nbrs[x], nbrs[y]
                d1, d2 = blen[(i, j)], blen[(j, k)]
                th = theta
                # both flank atoms in the same small ring as the center
                if (theta_ring is not None and g.ring_size[i] == g.ring_size[j]
                        and g.ring_size[k] == g.ring_size[j]):
                    th = theta_ring
                d13 = math.sqrt(max(
                    d1 * d1 + d2 * d2 - 2 * d1 * d2 * math.cos(th), 1e-6))
                if d13 * 0.95 > lower[i, k]:
                    lower[i, k] = lower[k, i] = d13 * 0.95
                if d13 * 1.05 < upper[i, k]:
                    upper[i, k] = upper[k, i] = d13 * 1.05
    # 1-4: cis..trans envelope from the two flanking angles
    def tors_dist(i, a, b, l, tors):
        d_ia, d_ab, d_bl = blen[(i, a)], blen[(a, b)], blen[(b, l)]
        th_a, th_b = g.angle[a], g.angle[b]
        # standard torsion distance formula
        c1, c2 = math.cos(math.pi - th_a), math.cos(math.pi - th_b)
        s1, s2 = math.sin(math.pi - th_a), math.sin(math.pi - th_b)
        d2 = (d_ia * d_ia + d_ab * d_ab + d_bl * d_bl
              + 2 * d_ia * d_ab * c1 + 2 * d_ab * d_bl * c2
              + 2 * d_ia * d_bl * (c1 * c2 - s1 * s2 * math.cos(tors)))
        return math.sqrt(max(d2, 1e-6))

    for a, b, _, _ in g.edges:
        for i, _, _ in g.adj[a]:
            if i == b:
                continue
            for l, _, _ in g.adj[b]:
                if l == a or l == i:
                    continue
                for tors, is_upper in ((math.pi, True), (0.0, False)):
                    d = tors_dist(i, a, b, l, tors)
                    if is_upper:
                        if d * 1.05 < upper[i, l]:
                            upper[i, l] = upper[l, i] = d * 1.05
                    else:
                        lo = max(d * 0.80,
                                 0.7 * (_vdw(g.elem[i]) + _vdw(g.elem[l])))
                        if lo > lower[i, l] and lo < upper[i, l]:
                            lower[i, l] = lower[l, i] = lo
    # stereo-marked double bonds: collapse the free cis..trans envelope
    # of each assigned substituent pair to a tight band at the cis (0)
    # or trans (pi) torsion distance
    for i, a, b, l, is_trans in g.cistrans:
        if (i, a) not in blen or (a, b) not in blen or (b, l) not in blen:
            continue
        d = tors_dist(i, a, b, l, math.pi if is_trans else 0.0)
        lower[i, l] = lower[l, i] = d * 0.97
        upper[i, l] = upper[l, i] = d * 1.03
    # default lower bound: scaled vdW for everything still unset
    for i in range(n):
        for k in range(i + 1, n):
            if lower[i, k] == 0.0:
                lo = 0.8 * (_vdw(g.elem[i]) + _vdw(g.elem[k]))
                lower[i, k] = lower[k, i] = min(lo, upper[i, k] * 0.9)
    np.fill_diagonal(upper, 0.0)
    np.fill_diagonal(lower, 0.0)
    # triangle smoothing (vectorized Floyd-Warshall over k)
    for k in range(n):
        uk = upper[:, k][:, None] + upper[k, :][None, :]
        np.minimum(upper, uk, out=upper)
        lk = np.maximum(lower[:, k][:, None] - upper[k, :][None, :],
                        lower[k, :][None, :] - upper[:, k][:, None])
        np.maximum(lower, lk, out=lower)
    lower = np.minimum(lower, upper)  # numerical guard
    return lower, upper


def _embed_once(lower: np.ndarray, upper: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
    n = lower.shape[0]
    frac = rng.uniform(0.3, 0.7, size=(n, n))
    frac = (frac + frac.T) / 2.0
    d = lower + frac * (upper - lower)
    np.fill_diagonal(d, 0.0)
    d2 = d * d
    j = np.eye(n) - np.ones((n, n)) / n
    gram = -0.5 * j @ d2 @ j
    vals, vecs = np.linalg.eigh(gram)
    idx = np.argsort(vals)[::-1][:3]
    lam = np.sqrt(np.maximum(vals[idx], 1e-9))
    x = vecs[:, idx] * lam[None, :]
    if x.shape[1] < 3:  # n < 3 atoms: pad to the contract's (n, 3)
        x = np.pad(x, ((0, 0), (0, 3 - x.shape[1])))
    return x


def _chiral_volumes(x: np.ndarray, tetra) -> np.ndarray:
    """Signed triple product (n2-n1).((n3-n1)x(n4-n1)) per restraint."""
    idx = np.asarray([t[1] for t in tetra], dtype=np.int64)
    p1, p2, p3, p4 = x[idx[:, 0]], x[idx[:, 1]], x[idx[:, 2]], x[idx[:, 3]]
    return (np.cross(p3 - p1, p4 - p1) * (p2 - p1)).sum(-1)


def _orient_chirality(x: np.ndarray, tetra) -> np.ndarray:
    """Mirror the whole embedding when the majority of tetrahedral
    restraints come out with the wrong parity — classical MDS is
    reflection-blind, so half of all raw embeds start inverted."""
    if not tetra:
        return x
    vol = _chiral_volumes(x, tetra)
    signs = np.asarray([t[2] for t in tetra])
    if (np.sign(vol) != signs).sum() * 2 > len(tetra):
        x = x.copy()
        x[:, 0] = -x[:, 0]
    return x


_CHIRAL_MARGIN_DG = 0.5  # looser than the FF margin: bounds dominate here
_K_CHIRAL_DG = 0.3


def _refine(x: np.ndarray, lower: np.ndarray, upper: np.ndarray,
            iters: int = 200, lr: float = 0.05,
            tetra=()) -> Tuple[np.ndarray, float]:
    """Gradient descent on squared bound violations plus, when the
    molecule has tetrahedral markers, a flat-bottomed signed-volume
    penalty holding each stereocenter in its SMILES parity. Returns
    coords and the final stress (the offline stand-in for conformer
    energy; chirality violations count into it so multi-seed selection
    prefers the correct diastereomer)."""
    n = x.shape[0]
    eye = np.eye(n, dtype=bool)
    chir_idx = np.asarray([t[1] for t in tetra], dtype=np.int64) \
        if tetra else None
    chir_sign = np.asarray([t[2] for t in tetra]) if tetra else None
    stress = 0.0
    for _ in range(iters):
        diff = x[:, None, :] - x[None, :, :]
        dist = np.sqrt((diff * diff).sum(-1) + 1e-12)
        over = np.maximum(dist - upper, 0.0)
        under = np.maximum(lower - dist, 0.0)
        viol = over - under  # signed: positive pulls in, negative pushes out
        viol[eye] = 0.0
        stress = float((over * over + under * under).sum())
        grad = ((viol / dist)[:, :, None] * diff).sum(1)
        if chir_idx is not None:
            p1, p2 = x[chir_idx[:, 0]], x[chir_idx[:, 1]]
            p3, p4 = x[chir_idx[:, 2]], x[chir_idx[:, 3]]
            a, b, c = p2 - p1, p3 - p1, p4 - p1
            bc = np.cross(b, c)
            vol = (a * bc).sum(-1)
            gap = np.maximum(_CHIRAL_MARGIN_DG - chir_sign * vol, 0.0)
            stress += float(_K_CHIRAL_DG * (gap * gap).sum())
            act = gap > 0.0
            if act.any():
                pref = (-2.0 * _K_CHIRAL_DG * gap * chir_sign)[:, None]
                dv2 = bc
                dv3 = np.cross(c, a)
                dv4 = np.cross(a, b)
                dv1 = -(dv2 + dv3 + dv4)
                np.add.at(grad, chir_idx[:, 0], pref * dv1)
                np.add.at(grad, chir_idx[:, 1], pref * dv2)
                np.add.at(grad, chir_idx[:, 2], pref * dv3)
                np.add.at(grad, chir_idx[:, 3], pref * dv4)
        if stress < 1e-8:
            break
        x = x - lr * grad
    return x, stress


def _embed_with_graph(
    smiles: str,
    hydrogenate: bool = True,
    seed: int = 0xF00D,
    num_confs: int = 1,
    optimize: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float, "_HGraph"]:
    """embed_conformer plus the hydrogen-augmented working graph, so
    callers needing adjacency (embed_smiles_to_atoms_coords) don't
    re-parse and rebuild it. With optimize, every DG embedding is
    FIRE-relaxed under the MMFF-lite force field (chem/forcefield.py)
    and the LOWEST-ENERGY minimized conformer wins — the reference's
    EmbedMultipleConfs + MMFFOptimizeMoleculeConfs selection
    (rdkit_utils.py:177-199); the returned scalar is then the FF
    energy, not the DG stress."""
    mol = parse_smiles(smiles)
    g = _HGraph(mol, hydrogenate)
    lower, upper = _bounds(g)
    ff = None
    if optimize:
        from coati_tpu_torch.chem.forcefield import build_forcefield

        ff = build_forcefield(g, tetra=g.tetra, cistrans=g.cistrans)
    rng = np.random.default_rng(seed)
    best: Optional[Tuple[np.ndarray, float]] = None
    for _ in range(max(1, num_confs)):
        x0 = _embed_once(lower, upper, rng)
        x0 = _orient_chirality(x0, g.tetra)
        x, score = _refine(x0, lower, upper, tetra=g.tetra)
        if ff is not None:
            x, score = ff.minimize(x)
        if best is None or score < best[1]:
            best = (x, score)
    coords, score = best
    atoms = np.asarray(g.z, dtype=np.uint8)
    return atoms, np.asarray(coords, dtype=np.float64), score, g


def embed_conformer(
    smiles: str,
    hydrogenate: bool = True,
    seed: int = 0xF00D,
    num_confs: int = 1,
    optimize: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """(atoms Z uint8, coords (n,3) float64, score) for one molecule.
    num_confs > 1 embeds several seeds and keeps the best conformer:
    lowest DG stress, or lowest MMFF-lite energy when optimize=True
    (the reference's numConfs + MMFF94s-energy selection)."""
    atoms, coords, score, _ = _embed_with_graph(
        smiles, hydrogenate=hydrogenate, seed=seed, num_confs=num_confs,
        optimize=optimize,
    )
    return atoms, coords, score


def embed_smiles_to_atoms_coords(
    smiles: str,
    hydrogenate: bool = True,
    adj_matrix: bool = False,
    do_morgan: bool = False,
    optimize: bool = False,
    numConfs: int = 1,
    numThreads: int = 1,
):
    """Offline mol_to_atoms_coords (reference rdkit_utils.py:162-219
    contract): (atoms, coords[, adjacency][, morgan][, energy]).
    `optimize` MMFF-lite-minimizes each of numConfs embeddings, keeps
    the lowest-energy conformer and appends its energy (the reference's
    MMFFOptimizeMoleculeConfs semantics via chem/forcefield.py);
    numThreads accepted for signature parity."""
    del numThreads
    atoms, coords, stress, g = _embed_with_graph(
        smiles, hydrogenate=hydrogenate,
        num_confs=numConfs if optimize else 1, optimize=optimize,
    )
    out = [atoms, coords]
    if adj_matrix:
        n = atoms.shape[0]
        adj = np.zeros((n, n), dtype=np.int8)
        for a, b, _, _ in g.edges:
            adj[a, b] = adj[b, a] = 1
        out.append(adj)
    if do_morgan:
        from coati_tpu_torch.chem.fingerprints import morgan_fingerprint

        out.append(morgan_fingerprint(smiles, radius=3, n_bits=2048,
                                      chiral=False))
    if optimize:
        out.append(stress)
    return tuple(out)
