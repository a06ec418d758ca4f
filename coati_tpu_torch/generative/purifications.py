"""Embedding helpers of coati_tpu/generative/purifications.py.

Only `embed_smiles_batch` is ported so far; the purification and
interpolation routines of the JAX package come with the generative slice.
"""

from __future__ import annotations

from typing import List

import numpy as np

from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


def embed_smiles_batch(
    smiles_list: List[str], encoder: COATI, tokenizer: TrieTokenizer
) -> np.ndarray:
    """SMILES -> (B, embed_dim) float32 hclip vectors on the host."""
    tokens = np.asarray(
        [tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles_list],
        np.int32,
    )
    return encoder.encode_tokens(tokens, tokenizer).float().cpu().numpy()
