"""Fragment-recombination molecule enumeration (offline corpus synthesis).

The port's own copy of coati_tpu/chem/enumerate.py: the same code and the
same results, importing nothing of the JAX package.

The reference trains on multi-million-molecule s3 datasets
(reference coati/data/dataset.py:37-103 COATI_dataset over tensor
shards; README.md's grande run cites ~200M molecules); this machine has
zero egress and one 566-molecule pickle, so any generalization evidence
— the system's whole point, an embedding that decodes NOVEL valid
molecules (reference coati/generative/coati_purifications.py:100-154,
examples chembl_analysis.ipynb cell 26) — needs a corpus synthesized
in-tree. This module recombines single-cut fragments of seed molecules:

  1. every acyclic (bridge) single, non-stereo, uncharged-endpoint bond
     of every seed is a cut point; cutting yields two fragments, each
     with one open attachment atom;
  2. two fragments join with a new single bond between their attachment
     atoms. Because every cut bond and every join bond is SINGLE, each
     attachment atom's bond-order sum after the join is exactly what it
     was in its (valid) seed — recombination is valence-correct by
     construction, no post-hoc valence repair needed;
  3. join chemistry is restricted to unordered (symbol, symbol) pairs
     observed among the seeds' own cut bonds (symbol = element,
     lowercase when aromatic), so no bond type enters the corpus that
     the seed distribution doesn't already contain (no F-F, no
     alcohol+ether -> peroxide, ...);
  4. products are canonicalized (chem/graph_canon.canonical_smiles) and
     deduped at the molecule level; the (stereo-stripped, canonical)
     seeds themselves are part of the corpus.

Stereo is stripped from the seeds first: the offline conformer embedder
is achiral (chem/conformers.py documented scope cut), and stereo-free
strings make canonical dedup and round-trip accounting exact on this
image (no rdkit to normalize stereo writings).

Determinism: `enumerate_corpus` is a pure function of (seeds, n_target,
seed) — the committed corpus artifact is reproducible byte-for-byte.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

from coati_tpu_torch.chem.graph_canon import canonical_smiles
from coati_tpu_torch.chem.selfies_lite import (
    Atom,
    Bond,
    EncoderError,
    Mol,
    _bridges,
    parse_smiles,
    write_smiles,
)

__all__ = [
    "Fragment",
    "build_fragment_library",
    "combine",
    "enumerate_corpus",
]


def _strip_stereo(mol: Mol) -> None:
    for a in mol.atoms:
        a.chirality = ""
    for b in mol.bonds:
        b.stereo = ""
        b.stereo_at = -1


def _fresh_mol(atoms: List[Atom], bonds: List[Bond]) -> Mol:
    """Assemble a standalone Mol from copied atoms/bonds: rebuild the
    written-order lists (only consumed by the chirality fixup, inert
    here — stereo is stripped) and leave the parse tree empty."""
    m = Mol()
    m.atoms = atoms
    m.bonds = bonds
    m.written = [[] for _ in atoms]
    for bi, bd in enumerate(bonds):
        m.written[bd.a].append(bi)
        m.written[bd.b].append(bi)
    return m


def _copy_atom(a: Atom, idx: int) -> Atom:
    return Atom(
        element=a.element,
        aromatic=a.aromatic,
        charge=a.charge,
        isotope=a.isotope,
        chirality="",
        hcount=a.hcount,
        idx=idx,
        frag=0,
    )


def _symbol(a: Atom) -> str:
    return a.element.lower() if a.aromatic else a.element


@dataclass
class Fragment:
    """One side of a single-cut: a standalone molecular graph plus the
    atom index whose (single) bond was removed."""

    mol: Mol
    attach: int
    attach_symbol: str
    n_heavy: int
    key: str  # canonical SMILES with the attachment atom isotope-tagged
    src: str  # canonical SMILES of the seed this was cut from


def _component(mol: Mol, start: int, skip_bond: int) -> List[int]:
    """Atom ids reachable from `start` without crossing `skip_bond`."""
    adj = mol.neighbors()
    seen = {start}
    stack = [start]
    while stack:
        u = stack.pop()
        for v, bi in adj[u]:
            if bi == skip_bond or v in seen:
                continue
            seen.add(v)
            stack.append(v)
    return sorted(seen)


def _extract(mol: Mol, atom_ids: List[int], skip_bond: int,
             attach_old: int) -> Tuple[Mol, int]:
    remap = {old: new for new, old in enumerate(atom_ids)}
    atoms = [_copy_atom(mol.atoms[old], new)
             for new, old in enumerate(atom_ids)]
    bonds = [
        Bond(remap[bd.a], remap[bd.b], bd.order, bd.aromatic, "", -1)
        for bi, bd in enumerate(mol.bonds)
        if bi != skip_bond and bd.a in remap and bd.b in remap
    ]
    return _fresh_mol(atoms, bonds), remap[attach_old]


def _fragment_key(frag_mol: Mol, attach: int) -> Optional[str]:
    """Canonical identity of a fragment: its SMILES with the attachment
    atom isotope-tagged (so c1ccccc1[99CH3] != [99cH]1ccccc1C). Returns
    None for the rare fragment whose attachment atom already carries an
    isotope (can't be tagged unambiguously — caller drops it)."""
    at = frag_mol.atoms[attach]
    if at.isotope:
        return None
    at.isotope = 99
    try:
        return canonical_smiles(write_smiles(frag_mol))
    except EncoderError:
        return None
    finally:
        at.isotope = 0


def _cut_points(mol: Mol) -> List[int]:
    """Bond indices eligible for cutting: acyclic (bridge), order-1,
    non-aromatic, both endpoints uncharged (charged attachment atoms
    would let recombination separate a zwitterion's poles)."""
    out = []
    for bi in sorted(_bridges(mol)):
        bd = mol.bonds[bi]
        if bd.order != 1 or bd.aromatic:
            continue
        if mol.atoms[bd.a].charge or mol.atoms[bd.b].charge:
            continue
        out.append(bi)
    return out


def build_fragment_library(
    seed_smiles: Iterable[str],
    max_frag_heavy: int = 48,
) -> Tuple[List[Fragment], Set[Tuple[str, str]], List[str]]:
    """Cut every eligible bond of every seed.

    Returns (fragments deduped by canonical key, the set of unordered
    attachment-symbol pairs observed across all cuts, and the seeds as
    stereo-stripped canonical SMILES — parse failures skipped)."""
    frags: Dict[str, Fragment] = {}
    join_pairs: Set[Tuple[str, str]] = set()
    seeds_canon: List[str] = []
    seen_seed: Set[str] = set()
    for smi in seed_smiles:
        try:
            mol = parse_smiles(smi)
        except EncoderError:
            continue
        if len({a.frag for a in mol.atoms}) != 1:
            continue  # multi-component rows (salts) are not cut
        _strip_stereo(mol)
        try:
            canon = canonical_smiles(write_smiles(mol))
        except EncoderError:
            continue
        if canon in seen_seed:
            continue
        seen_seed.add(canon)
        seeds_canon.append(canon)
        for bi in _cut_points(mol):
            bd = mol.bonds[bi]
            sa, sb = _symbol(mol.atoms[bd.a]), _symbol(mol.atoms[bd.b])
            join_pairs.add((min(sa, sb), max(sa, sb)))
            for attach_old in (bd.a, bd.b):
                ids = _component(mol, attach_old, bi)
                if not 1 <= len(ids) <= max_frag_heavy:
                    continue
                fmol, attach = _extract(mol, ids, bi, attach_old)
                key = _fragment_key(fmol, attach)
                if key is None or key in frags:
                    continue
                frags[key] = Fragment(
                    mol=fmol,
                    attach=attach,
                    attach_symbol=_symbol(fmol.atoms[attach]),
                    n_heavy=len(ids),
                    key=key,
                    src=canon,
                )
    return list(frags.values()), join_pairs, seeds_canon


def combine(fa: Fragment, fb: Fragment) -> Mol:
    """Join two fragments with a single bond between their attachment
    atoms. Valence-correct by construction (module docstring pt. 2)."""
    off = len(fa.mol.atoms)
    atoms = [_copy_atom(a, i) for i, a in enumerate(fa.mol.atoms)]
    atoms += [_copy_atom(a, off + i) for i, a in enumerate(fb.mol.atoms)]
    bonds = [Bond(b.a, b.b, b.order, b.aromatic, "", -1)
             for b in fa.mol.bonds]
    bonds += [Bond(b.a + off, b.b + off, b.order, b.aromatic, "", -1)
              for b in fb.mol.bonds]
    bonds.append(Bond(fa.attach, fb.attach + off, 1, False, "", -1))
    return _fresh_mol(atoms, bonds)


def enumerate_corpus(
    seed_smiles: Iterable[str],
    n_target: int,
    seed: int = 0,
    min_heavy: int = 10,
    max_heavy: int = 52,
    accept: Optional[Callable[[str], bool]] = None,
    max_attempts: Optional[int] = None,
) -> Dict:
    """Sample recombination products until `n_target` unique canonical
    molecules (seeds included) or the attempt budget runs out.

    `accept(canonical_smiles) -> bool` adds caller filters (e.g. token
    length under the training n_seq). Returns a dict with the sorted
    corpus, the seeds, and accounting stats."""
    frags, join_pairs, seeds_canon = build_fragment_library(seed_smiles)
    rng = random.Random(seed)
    corpus: Set[str] = set(seeds_canon)
    if accept is not None:
        corpus = {s for s in corpus if accept(s)}
    stats = {
        "n_seeds": len(seeds_canon),
        "n_fragments": len(frags),
        "n_join_pairs": len(join_pairs),
        "attempts": 0,
        "rejected_pair": 0,
        "rejected_size": 0,
        "rejected_parse": 0,
        "rejected_accept": 0,
        "duplicates": 0,
    }
    if max_attempts is None:
        max_attempts = 60 * n_target
    by_sym: Dict[str, List[Fragment]] = {}
    for f in frags:
        by_sym.setdefault(f.attach_symbol, []).append(f)
    symbols = sorted(by_sym)
    while len(corpus) < n_target and stats["attempts"] < max_attempts:
        stats["attempts"] += 1
        fa = frags[rng.randrange(len(frags))]
        # draw the partner from a symbol the seeds actually bond to fa's
        # attachment symbol, so the pair filter rarely fires
        ok_syms = [s for s in symbols
                   if (min(fa.attach_symbol, s), max(fa.attach_symbol, s))
                   in join_pairs]
        if not ok_syms:
            stats["rejected_pair"] += 1
            continue
        pool = by_sym[ok_syms[rng.randrange(len(ok_syms))]]
        fb = pool[rng.randrange(len(pool))]
        n = fa.n_heavy + fb.n_heavy
        if not min_heavy <= n <= max_heavy:
            stats["rejected_size"] += 1
            continue
        try:
            smi = canonical_smiles(write_smiles(combine(fa, fb)))
        except EncoderError:
            stats["rejected_parse"] += 1
            continue
        if accept is not None and not accept(smi):
            stats["rejected_accept"] += 1
            continue
        if smi in corpus:
            stats["duplicates"] += 1
            continue
        corpus.add(smi)
    stats["n_corpus"] = len(corpus)
    stats["n_novel"] = len(corpus - set(seeds_canon))
    return {
        "corpus": sorted(corpus),
        "seeds": seeds_canon,
        "stats": stats,
    }
