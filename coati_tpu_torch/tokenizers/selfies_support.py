"""SELFIES tokenization support.

The port's own copy of coati_tpu/tokenizers/selfies_support.py: the same
code and the same results, importing nothing of the JAX package.

Parity target: coati/models/encoding/clip_e2e_selfies.py:13-31
(selfies_pre_tokenize / to_selfies_tokenizer) — the tokenizer's
pre_tokenize is rebound so non-special text routes through
selfies.encoder before vocab matching; plus the selfies training xform
variant (clip_ar_xform_selfies :34-315) which consumes pre-computed
'selfies'/'rand_selfies' dataset columns.

The `selfies` package is preferred whenever importable; otherwise the
in-tree SELFIES v2 implementation (chem/selfies_lite.py) provides the
same encoder/decoder so the route still executes offline. SELFIES_IMPL
records which one is live.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

try:
    import selfies as sf

    HAS_REAL_SELFIES = True
except ImportError:
    from coati_tpu_torch.chem import selfies_lite as sf

    HAS_REAL_SELFIES = False

HAS_SELFIES = True  # an implementation is always available
SELFIES_IMPL = "selfies" if HAS_REAL_SELFIES else "lite"

from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer  # noqa: E402


def require_selfies() -> None:
    """Retained for API compatibility: a SELFIES implementation is
    always available (the in-tree codec backs the absent package)."""


def selfies_pre_tokenize(tokenizer: TrieTokenizer, text: str):
    """Split special tokens first; encode the remaining spans to SELFIES
    before SMILES-vocab matching."""
    require_selfies()
    out = []
    for piece in tokenizer.special_matcher.split(text):
        if piece in tokenizer._special_set:
            out.append(piece)
        else:
            out.extend(tokenizer.smiles_matcher.split(sf.encoder(piece)))
    return out


def to_selfies_tokenizer(tokenizer: TrieTokenizer) -> TrieTokenizer:
    """Rebind pre_tokenize to the SELFIES route (reference monkey-patch
    pattern, clip_e2e_selfies.py:29-31)."""
    tokenizer.pre_tokenize = selfies_pre_tokenize.__get__(tokenizer)
    return tokenizer


def selfies_to_smiles(selfies_str: str) -> str:
    require_selfies()
    return sf.decoder(selfies_str)


def clip_ar_xform_selfies(
    batch: Dict,
    tokenizer: TrieTokenizer,
    p_dataset: float = 0.2,
    p_formula: float = 0.2,
    p_fim: float = 0.0,
    p_graph: float = 0.0,
    p_clip: float = 0.9,
    p_clip_cut: float = 0.3,
    p_randsmiles: float = 0.0,
    coord_noise: bool = False,
    pad_width_to: int = 16,
    rng=None,
):
    """SELFIES training xform: identical augmentation logic to
    clip_ar_xform but sourcing pre-computed 'selfies' / 'rand_selfies'
    cache columns (clip_e2e_selfies.py:34-315). Pass a PLAIN tokenizer
    on a selfies vocabulary (the reference trains with one — selfies
    tokens match the vocab trie directly; the to_selfies_tokenizer
    rebinding is for raw-SMILES inference text and would re-encode the
    already-encoded columns).

    Beyond parity: when the dataset has no 'selfies' column (the
    reference assumes cache preprocessing wrote one), it is computed on
    the fly from 'smiles' with the live SELFIES implementation — rows
    whose SMILES fail to encode pass through verbatim and are dropped
    by the tokenizer's row-level fault tolerance, matching
    clip_ar_xform's bad-row semantics."""
    from coati_tpu_torch.data.xform import clip_ar_xform

    sel_batch = dict(batch)
    if "selfies" not in batch:
        encoded = []
        for s in batch["smiles"]:
            try:
                encoded.append(sf.encoder(str(s)))
            except Exception:  # noqa: BLE001 - row-level fault tolerance
                encoded.append(str(s))
        sel_batch["selfies"] = encoded
        batch = sel_batch
    # route the precomputed selfies strings through the standard pipeline
    sel_batch["smiles"] = [str(s) for s in batch["selfies"]]
    if "rand_selfies" in batch:
        # random-permutation targets come from the cache, not RDKit
        sel_batch["rand_smiles"] = [str(s) for s in batch["rand_selfies"]]
    return clip_ar_xform(
        sel_batch,
        tokenizer,
        # cached selfies are used VERBATIM (clip_e2e_selfies.py:76) —
        # RDKit would parse '[C][C][O]' as bracket-atom SMILES and
        # rewrite it out of the selfies vocabulary
        canonicalize=False,
        p_dataset=p_dataset,
        p_formula=p_formula,
        p_fim=p_fim,
        p_graph=p_graph,
        p_clip=p_clip,
        p_clip_cut=p_clip_cut,
        p_randsmiles=p_randsmiles if "rand_selfies" in batch else 0.0,
        coord_noise=coord_noise,
        pad_width_to=pad_width_to,
        rng=rng,
    )
