"""Canonical SMILES via the in-tree parser (no RDKit).

The port's own copy of coati_tpu/chem/graph_canon.py: the same code and the
same results, importing nothing of the JAX package.

Canonical atom ranking = Weisfeiler-Lehman (Morgan-style) iterative
refinement over graph-invariant atom seeds, followed by a branch-and-
bound tie-break: every member of the first ambiguous cell is tried and
the lexicographically smallest resulting SMILES wins. Because the
candidate set depends only on the molecular graph (never on input atom
order), the result is invariant under re-writings of the same molecule
— the property RDKit's Chem.CanonSmiles provides and the reference
uses for dedup/uniqueness statistics and augmentation targets
(reference containers/rdkit_utils.py:82 canon_smiles,
:104 identical_canonsmi; used all over examples/*.ipynb cell 26-style
validity/uniqueness accounting).

Scope and limits (documented, not silent):
- Aromaticity is RE-PERCEIVED on entry (chem/aromaticity.py, the
  RDKit default model), so a kekulized writing and an aromatic writing
  of the same molecule canonicalize to ONE string — the
  Chem.CanonSmiles unification property. SELFIES decodes (kekulized)
  therefore dedup correctly against aromatic dataset forms.
- Tetrahedral markers are re-oriented per traversal by the writer's
  parity fixup (selfies_lite.write_smiles), so stereo SMILES
  canonicalize consistently; agreement with RDKit's absolute @/@@
  convention is asserted by a gated test when rdkit is importable.
- The tie-break search is capped at `budget` leaf writings; molecules
  that exhaust it (pathologically symmetric graphs far beyond drug
  space) fall back to first-member tie-breaks, which may depend on
  input order. Druglike molecules resolve in a handful of leaves.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional, Tuple

from coati_tpu_torch.chem.selfies_lite import (
    Atom,
    Bond,
    EncoderError,
    Mol,
    _bridges,
    _perm_parity,
    _SMILES_VALENCE,
    kekulize,
    parse_smiles,
    write_smiles,
)

__all__ = ["canonical_smiles", "canonical_ranks", "implicit_hydrogens"]


def implicit_hydrogens(mol: Mol) -> List[int]:
    """Per-atom total hydrogen count (explicit bracket H, or the
    OpenSMILES organic-subset ladder on the kekulized graph). The count
    is kekule-choice-independent, so it is a valid canonical invariant
    even though individual bond orders are not."""
    # kekulize mutates bond orders and atom aromatic flags — copy both
    # shallowly via positional constructors (dataclasses.replace is
    # several times slower in this host hot path)
    km = Mol(
        atoms=[
            Atom(a.element, a.aromatic, a.charge, a.isotope,
                 a.chirality, a.hcount, a.idx, a.frag)
            for a in mol.atoms
        ],
        bonds=[Bond(b.a, b.b, b.order, b.aromatic) for b in mol.bonds],
        roots=mol.roots,
    )
    kekulize(km)
    bond_sum = [0] * len(km.atoms)
    for b in km.bonds:
        bond_sum[b.a] += b.order
        bond_sum[b.b] += b.order
    out = []
    for a in km.atoms:
        if a.hcount is not None:
            out.append(a.hcount)
            continue
        ladder = _SMILES_VALENCE.get(a.element, (0,))
        v = next((x for x in ladder if x >= bond_sum[a.idx]), bond_sum[a.idx])
        out.append(v - bond_sum[a.idx])
    return out


def _dense_ranks(keys: list) -> List[int]:
    order = sorted(set(keys))
    lut = {k: i for i, k in enumerate(order)}
    return [lut[k] for k in keys]


def _labeled_adj(mol: Mol) -> List[List[Tuple[int, int]]]:
    """(edge label, neighbor) lists; aromatic bonds get label 5 so a
    kekule choice can never leak into the ranking."""
    adj: List[List[Tuple[int, int]]] = [[] for _ in mol.atoms]
    for b in mol.bonds:
        label = 5 if b.aromatic else b.order
        adj[b.a].append((label, b.b))
        adj[b.b].append((label, b.a))
    return adj


_M61 = (1 << 61) - 1


def _refine(ladj: List[List[Tuple[int, int]]], ranks: List[int]) -> List[int]:
    """WL refinement to a fixed point. Each round's per-atom key is the
    old rank plus a commutative 61-bit hash over the (edge label,
    neighbor rank) multiset — commutativity replaces the per-atom sort,
    and the two-step multiply/xor-shift mix makes an accidental multiset
    collision (which would merely coarsen the partition and defer the
    split to the tie-break search, never corrupt the result)
    astronomically unlikely. Pure int arithmetic: deterministic across
    processes and platforms."""
    n_classes = len(set(ranks))
    n = len(ranks)
    while True:
        keys: List[Tuple[int, int]] = []
        for i in range(n):
            s = 0
            for lb, j in ladj[i]:
                x = (((lb << 20) + ranks[j]) * 0x9E3779B97F4A7C15) & _M61
                x ^= x >> 29
                s = (s + x * 0xBF58476D1CE4E5B9) & _M61
            keys.append((ranks[i], s))
        new = _dense_ranks(keys)
        new_classes = len(set(new))
        if new_classes == n_classes:
            return new
        ranks, n_classes = new, new_classes


def canonical_ranks(mol: Mol) -> List[int]:
    """Refined (possibly non-discrete) invariant ranks. Chirality tags
    are deliberately excluded: @/@@ are writing-order-dependent, so
    they are not graph invariants — stereo is resolved at write time by
    the parity fixup instead."""
    h = implicit_hydrogens(mol)
    bridges = _bridges(mol)
    in_ring = [False] * len(mol.atoms)
    for bi, b in enumerate(mol.bonds):
        if bi not in bridges:
            in_ring[b.a] = in_ring[b.b] = True
    ladj = _labeled_adj(mol)
    seeds = [
        (
            a.element,
            a.charge,
            a.isotope,
            bool(a.aromatic),
            len(ladj[a.idx]),
            h[a.idx],
            in_ring[a.idx],
        )
        for a in mol.atoms
    ]
    return _refine(ladj, _dense_ranks(seeds))


def _first_ambiguous_cell(ranks: List[int]) -> Optional[List[int]]:
    cells: dict = {}
    for i, r in enumerate(ranks):
        cells.setdefault(r, []).append(i)
    for r in sorted(cells):
        if len(cells[r]) > 1:
            return cells[r]
    return None


def _bump(ranks: List[int], chosen: int) -> List[int]:
    """Give `chosen` its own class just below its former cell."""
    keys: List[Tuple[int, int]] = [
        (r, 0 if i == chosen else 1) for i, r in enumerate(ranks)
    ]
    return _dense_ranks(keys)


def _chi_rank(
    mol: Mol,
    biadj: List[List[Tuple[int, int, int]]],
    ranks: List[int],
    u: int,
    input_roots: set,
) -> str:
    """The @/@@ marker of atom u re-oriented against the neighbor order
    'ascending leaf rank, implicit H first' — an input-order-invariant
    normal form of the absolute configuration (the same parity algebra
    as write_smiles' fixup, against a rank-defined reference order
    instead of the traversal order)."""
    a = mol.atoms[u]
    if a.chirality not in ("@", "@@") or len(mol.written) != len(mol.atoms):
        return a.chirality
    in_seq: list = list(mol.written[u])
    out_seq: list = [
        bi for _, _, bi in sorted(biadj[u], key=lambda t: ranks[t[1]])
    ]
    if a.hcount == 1:
        in_seq.insert(0 if u in input_roots else 1, "H")
        out_seq.insert(0, "H")
    if len(in_seq) < 3 or set(in_seq) != set(out_seq):
        return a.chirality  # defensive, mirrors the writer
    if _perm_parity(in_seq, out_seq):
        return "@@" if a.chirality == "@" else "@"
    return a.chirality


def _leaf_code(
    mol: Mol,
    biadj: List[List[Tuple[int, int, int]]],
    ranks: List[int],
    input_roots: set,
) -> tuple:
    """Total-order code of a discrete ranking: the rank-relabeled
    attributed graph plus rank-normalized stereo markers. Cheaper than
    writing the SMILES, and exactly as discriminating: equal codes mean
    the two rankings are related by an attribute- and stereo-preserving
    automorphism, so the written strings coincide — the min-code leaf
    therefore yields the min-string SMILES order-invariantly."""
    n = len(mol.atoms)
    atoms_code: List[Optional[tuple]] = [None] * n
    for a in mol.atoms:
        u = a.idx
        atoms_code[ranks[u]] = (
            a.element,
            a.aromatic,
            a.charge,
            a.isotope,
            -1 if a.hcount is None else a.hcount,
            _chi_rank(mol, biadj, ranks, u, input_roots),
            tuple(sorted((lb, ranks[j]) for lb, j, _ in biadj[u])),
        )
    stereo = []
    for b in mol.bonds:
        if b.stereo:
            ra, rb = ranks[b.a], ranks[b.b]
            lo = b.a if ra < rb else b.b
            mark = b.stereo if b.stereo_at == lo else (
                "/" if b.stereo == "\\" else "\\"
            )
            stereo.append((min(ra, rb), max(ra, rb), mark))
    stereo.sort()
    return (tuple(atoms_code), tuple(stereo))


def _search(
    mol: Mol,
    ladj: List[List[Tuple[int, int]]],
    biadj: List[List[Tuple[int, int, int]]],
    ranks: List[int],
    budget: List[int],
    input_roots: set,
) -> Tuple[tuple, List[int]]:
    ranks = _refine(ladj, ranks)
    cell = _first_ambiguous_cell(ranks)
    if cell is None:
        return _leaf_code(mol, biadj, ranks, input_roots), ranks
    if budget[0] <= 0:
        # budget exhausted: deterministic-but-not-order-invariant fallback
        return _search(mol, ladj, biadj, _bump(ranks, cell[0]), budget, input_roots)
    # NOTE: nauty-style orbit pruning (deriving automorphisms from
    # equal-code leaf pairs) was tried and removed: on druglike corpora
    # cells are almost always size 2 — both members must be explored
    # before an automorphism is even observable — so it skipped ~0.1%
    # of leaves while taxing every equal-code comparison.
    best: Optional[Tuple[tuple, List[int]]] = None
    for member in cell:
        budget[0] -= 1
        cand = _search(mol, ladj, biadj, _bump(ranks, member), budget, input_roots)
        if best is None or cand[0] < best[0]:
            best = cand
        if budget[0] <= 0:
            break
    assert best is not None
    return best


_NATIVE_BUF_CAP = 16384


def _try_native(smiles: str, use_chiral: bool, budget: int) -> Optional[str]:
    """The C pipeline (native/fast_canon.c): byte-identical to the
    Python path below (fuzz-verified, coati_tpu's tests/test_fast_canon.py) at ~30x
    the cold throughput. Returns None when the C library is unavailable
    or reports the input unsupported/unparseable — the Python path then
    decides (and raises EncoderError with proper detail on bad input)."""
    import ctypes

    from coati_tpu_torch.native import load_fast_canon

    lib = load_fast_canon()
    if lib is None:
        return None
    try:
        raw = smiles.encode("ascii")
    except UnicodeEncodeError:
        return None  # non-ASCII: Python path raises its own error
    buf = ctypes.create_string_buffer(_NATIVE_BUF_CAP)
    status = lib.canonical_smiles_native(
        raw, int(use_chiral), int(budget), buf, _NATIVE_BUF_CAP
    )
    if status != 0:
        return None
    return buf.value.decode("ascii")


@lru_cache(maxsize=200_000)
def _canonical_cached(smiles: str, use_chiral: bool, budget: int) -> str:
    from coati_tpu_torch.native import CANON_PATHS

    native = _try_native(smiles, use_chiral, budget)
    if native is not None:
        CANON_PATHS["native"] += 1
        return native
    CANON_PATHS["python"] += 1
    return _canonical_python(smiles, use_chiral, budget)


def _canonical_python(smiles: str, use_chiral: bool, budget: int) -> str:
    """The pure-Python pipeline — the SPEC the C port is fuzz-verified
    against, and the fallback for unsupported input."""
    # deferred import: aromaticity pulls implicit_hydrogens from here
    from coati_tpu_torch.chem.aromaticity import perceive_aromaticity

    mol = parse_smiles(smiles)
    # rdkit-model aromaticity perception: a kekulized writing and an
    # aromatic writing of one molecule unify to the same canonical form
    # (reference containers/rdkit_utils.py:82 Chem.CanonSmiles semantics)
    perceive_aromaticity(mol)
    if not use_chiral:
        for a in mol.atoms:
            a.chirality = ""
        for b in mol.bonds:
            b.stereo = ""
            b.stereo_at = -1
    else:
        # Degenerate @/@@ (fewer than 3 written neighbors incl. the
        # one explicit H) carries no stereochemistry; the writer's
        # defensive branch passes such markers through UNORIENTED,
        # which would leak input atom order into the canonical form
        # (caught by grammar-soup fuzz). Strip them up front — RDKit
        # likewise discards non-stereogenic markers.
        have_written = len(mol.written) == len(mol.atoms)
        for a in mol.atoms:
            if a.chirality and have_written:
                nb = len(mol.written[a.idx]) + (1 if a.hcount == 1 else 0)
                if nb < 3:
                    a.chirality = ""
    ranks = canonical_ranks(mol)
    biadj: List[List[Tuple[int, int, int]]] = [[] for _ in mol.atoms]
    for bi, b in enumerate(mol.bonds):
        label = 5 if b.aromatic else b.order
        biadj[b.a].append((label, b.b, bi))
        biadj[b.b].append((label, b.a, bi))
    input_roots = {node.atom for node in mol.roots}
    _, leaf_ranks = _search(
        mol, _labeled_adj(mol), biadj, ranks, [budget], input_roots
    )
    return write_smiles(mol, order=leaf_ranks)


def canonical_smiles(
    smiles: str, use_chiral: bool = True, budget: int = 512
) -> str:
    """Canonical SMILES of `smiles` under atom-order permutation.
    use_chiral=False strips tetrahedral and cis/trans markers first
    (reference identical_canonsmi's useChiral=0 semantics,
    rdkit_utils.py:104-108). Raises EncoderError on unparseable input.
    LRU-cached (the training xform canonicalizes the same corpus every
    epoch; steady-state cost is a dict hit)."""
    return _canonical_cached(smiles, use_chiral, budget)
