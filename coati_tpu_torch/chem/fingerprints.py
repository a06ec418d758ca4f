"""Circular (Morgan/ECFP-style) fingerprints via the in-tree parser.

The port's own copy of coati_tpu/chem/fingerprints.py: the same code and the
same results, importing nothing of the JAX package.

Offline substitute for RDKit's GetMorganFingerprintAsBitVect (reference
containers/rdkit_utils.py:94 sim_mol ECFP4/2048, :140 mol_to_morgan) so
that fingerprint training targets (clip_fp_e2e.py:21,273-278 via
data/xform.py fp_targets) and Tanimoto similarity work without the
package. The construction is standard ECFP: per-atom seed invariants
(atomic number, heavy degree, total H, charge, ring membership,
aromaticity), `radius` rounds of neighborhood hashing over sorted
(bond label, neighbor hash) lists, every intermediate environment
hashed onto `n_bits` via modulo folding.

NOT bit-compatible with RDKit: RDKit's exact invariant packing and
boost hash are not replicated, so individual bit positions differ.
Rank structure (self-similarity 1.0, near-analogs high, unrelated
scaffolds low) is what downstream consumers rely on and is tested; a
gated test asserts behavioral agreement (Tanimoto rank correlation)
whenever rdkit is importable. Deterministic across processes (FNV-1a,
no PYTHONHASHSEED dependence).
"""

from __future__ import annotations

from typing import List, Set

import numpy as np

from coati_tpu_torch.chem.graph_canon import implicit_hydrogens
from coati_tpu_torch.chem.selfies_lite import Mol, _bridges, parse_smiles

__all__ = ["morgan_fingerprint", "tanimoto", "smiles_similarity"]

# symbol -> atomic number, lazily built from the shipped periodic table
_Z: dict = {}


def _atomic_number(symbol: str) -> int:
    if not _Z:
        from coati_tpu_torch.common.periodic_table import PERIODIC_TABLE

        _Z.update({e["symbol"]: e["number"] for e in PERIODIC_TABLE})
    return _Z.get(symbol, 0)


def _fnv(vals: List[int]) -> int:
    """32-bit FNV-1a over a list of (masked) ints — stable across
    processes and platforms, unlike builtin hash()."""
    h = 2166136261
    for v in vals:
        v &= 0xFFFFFFFF
        for shift in (0, 8, 16, 24):
            h ^= (v >> shift) & 0xFF
            h = (h * 16777619) & 0xFFFFFFFF
    return h


def _environments(mol: Mol, radius: int, chiral: bool) -> Set[int]:
    h = implicit_hydrogens(mol)
    bridges = _bridges(mol)
    in_ring = [False] * len(mol.atoms)
    for bi, b in enumerate(mol.bonds):
        if bi not in bridges:
            in_ring[b.a] = in_ring[b.b] = True
    ladj: List[List[tuple]] = [[] for _ in mol.atoms]
    for b in mol.bonds:
        label = 5 if b.aromatic else b.order
        ladj[b.a].append((label, b.b))
        ladj[b.b].append((label, b.a))
    cur = [
        _fnv(
            [
                _atomic_number(a.element),
                len(ladj[a.idx]),
                h[a.idx],
                a.charge + 8,
                int(in_ring[a.idx]),
                int(a.aromatic),
                # presence-only: @/@@ orientation is writing-order
                # dependent, so only "is a stereocenter" is invariant
                int(bool(a.chirality)) if chiral else 0,
            ]
        )
        for a in mol.atoms
    ]
    feats: Set[int] = set(cur)
    for r in range(1, radius + 1):
        cur = [
            _fnv(
                [r, cur[i]]
                + [x for lb, j in sorted((lb, cur[j]) for lb, j in ladj[i]) for x in (lb, j)]
            )
            for i in range(len(mol.atoms))
        ]
        feats.update(cur)
    return feats


def morgan_fingerprint(
    smiles: str, radius: int = 3, n_bits: int = 2048, chiral: bool = False
) -> np.ndarray:
    """ECFP-style bit vector (uint8 0/1 array of length n_bits).
    radius=2 corresponds to ECFP4. Raises EncoderError on unparseable
    SMILES (mirror of RDKit raising on bad mol)."""
    mol = parse_smiles(smiles)
    bits = np.zeros((n_bits,), dtype=np.uint8)
    for f in _environments(mol, radius, chiral):
        bits[f % n_bits] = 1
    return bits


def tanimoto(fp1: np.ndarray, fp2: np.ndarray) -> float:
    a = np.asarray(fp1, dtype=bool)
    b = np.asarray(fp2, dtype=bool)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)


def smiles_similarity(s1: str, s2: str) -> float:
    """ECFP4/2048 Tanimoto (reference sim_mol semantics,
    rdkit_utils.py:94-103) computed fully in-tree."""
    return tanimoto(
        morgan_fingerprint(s1, radius=2, n_bits=2048),
        morgan_fingerprint(s2, radius=2, n_bits=2048),
    )
