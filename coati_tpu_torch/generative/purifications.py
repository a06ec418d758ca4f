"""Embedding and decoding helpers over the invertible COATI latent space.

Counterpart of coati_tpu/generative/purifications.py (itself the
reference's coati_purifications): embed a SMILES or its 3D conformer,
purify a vector toward the mean embedding of its decodes, and redecode a
vector until a valid SMILES comes out. Validity is RDKit's when installed,
else the in-tree parser's (chem/rdkit_support.is_valid_smiles).

Where coati_tpu catches every exception around a decode, these put no
try around the decode itself: whatever it raises (a kernel wrapper's
ValueError for inputs it cannot launch with, a RuntimeError of a kernel
that did not build or launch, a CUDA error) reaches the caller. Only the
host parsing of a decoded string is caught, where an unusable SMILES
raises the tokenizer's KeyError (an unknown token) or ValueError (longer
than n_seq).
"""

from __future__ import annotations

from typing import List

import numpy as np

from coati_tpu_torch.chem.rdkit_support import (
    canonicalize_or_self,
    is_valid_smiles,
    mol_to_atoms_coords,
)
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

# what tokenizing a decoded SMILES that is of no use raises
UNUSABLE_DECODE = (KeyError, ValueError)


def _host(h) -> np.ndarray:
    return h.float().cpu().numpy()


def embed_points(s: str, encoder: COATI) -> np.ndarray:
    """SMILES -> 3D conformer (the in-tree embedder, or RDKit's) -> point
    encoder embedding, (1, D) float32 on the host."""
    atoms, coords = mol_to_atoms_coords(s)
    return _host(encoder.encode_points(
        np.asarray(atoms)[None, :], np.asarray(coords, np.float32)[None, :, :]))


def embed_smiles(s: str, encoder: COATI, tokenizer: TrieTokenizer) -> np.ndarray:
    """Canonicalize + tokenize + encode one SMILES -> (D,) float32."""
    s = canonicalize_or_self(s)
    tokens = np.asarray(
        [tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)], np.int32
    )
    return _host(encoder.encode_tokens(tokens, tokenizer))[0]


def embed_smiles_batch(
    smiles_list: List[str], encoder: COATI, tokenizer: TrieTokenizer
) -> np.ndarray:
    """SMILES -> (B, embed_dim) float32 hclip vectors on the host."""
    tokens = np.asarray(
        [tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles_list],
        np.int32,
    )
    return _host(encoder.encode_tokens(tokens, tokenizer))


def purify_vector(
    V: np.ndarray,
    encoder: COATI,
    tokenizer: TrieTokenizer,
    n_rep: int = 128,
) -> np.ndarray:
    """Push V toward the average of embed(decode(V)) over n_rep decodes:
    the idempotent part of the vector under the decode-embed map. V comes
    back unchanged when no decode is a valid, tokenizable SMILES."""
    V = np.asarray(V, np.float32).reshape(-1)
    regen = encoder.hclip_to_2d_batch(np.tile(V[None, :], (n_rep, 1)), tokenizer)
    tokens = []
    for s in regen:
        if not is_valid_smiles(s):
            continue
        try:
            tokens.append(
                tokenizer.tokenize_text("[SMILES]" + canonicalize_or_self(s) + "[STOP]", pad=True)
            )
        except UNUSABLE_DECODE:
            continue
    if not tokens:
        return V
    return _host(encoder.encode_tokens(np.asarray(tokens, np.int32), tokenizer)).mean(0)


def force_decode_valid(
    V: np.ndarray,
    encoder: COATI,
    tokenizer: TrieTokenizer,
    max_attempts: int = 2000,
) -> str:
    """Redecode until a valid SMILES appears; 'C' as a last resort."""
    V = np.asarray(V, np.float32).reshape(-1)
    for _ in range(max_attempts):
        s = encoder.hclip_to_2d(V, tokenizer)
        if is_valid_smiles(s):
            return s
    return "C"


def force_decode_valid_batch(
    V: np.ndarray,
    encoder: COATI,
    tokenizer: TrieTokenizer,
    batch_size: int = 128,
    max_attempts: int = 4,
) -> str:
    """batch_size parallel redecodes per attempt; the most common valid
    canonical SMILES, or 'C' when no attempt gives one."""
    V = np.asarray(V, np.float32).reshape(-1)
    for _ in range(max_attempts):
        regen = encoder.hclip_to_2d_batch(np.tile(V[None, :], (batch_size, 1)), tokenizer)
        valid = [canonicalize_or_self(s) for s in regen if is_valid_smiles(s)]
        if valid:
            return max(set(valid), key=valid.count)
    return "C"
