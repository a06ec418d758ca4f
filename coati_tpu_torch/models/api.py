"""User-facing COATI model API.

The public surface of coati_tpu/models/api.py (itself the reference
e3gnn_smiles_clip_e2e's), on PyTorch:

    model, tokenizer = load_e3gnn_smiles_clip_e2e(doc_path)   # io.py
    h = model.encode_tokens(tokens, tokenizer)                 # (B, D)
    smiles = model.hclip_to_2d_batch(h, tokenizer, noise_scale=0.3)
    smiles = model.smiles_to_2d_batch(tokens, tokenizer)       # round trip

The model runs on the device its parameters lie on. Host noise is numpy
`default_rng(seed)`, as in the JAX package, so noisy decodes inject the
same embedding there and here; sampling draws from a torch.Generator on
the device. PyTorch runs eagerly, so the JAX package's batch bucketing
(which bounded XLA recompiles) is gone.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from coati_tpu_torch.models import coati
from coati_tpu_torch.models.coati import CoatiConfig, CoatiModel
from coati_tpu_torch.models.sampler import auto_stage_widths, generate_tokens
from coati_tpu_torch.ops.layers import cast_floats
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

_LATER_SLICE = (
    "the point encoder (EGNN and its message kernel) is not ported yet; it comes "
    "with the EGNN slice of the port"
)


class COATI:
    """Composite CLIP model: parameters + config + entry points."""

    def __init__(self, params: CoatiModel, config: CoatiConfig, seed: int = 0):
        self.params = params
        self.config = config
        self.embed_dim = config.embed_dim
        self.device = next(params.parameters()).device
        # the compute-dtype copy, cast once (the same module under float32)
        self._compute = cast_floats(params, config.xformer_config.compute_dtype)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._noise = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()  # np Generators are not thread-safe

    def _sample_noise(self, scale: float, shape) -> np.ndarray:
        with self._rng_lock:
            return self._noise.normal(scale=scale, size=shape).astype(np.float32)

    def _fused_noise(self, scale: float, b: int) -> np.ndarray:
        """Noise for b rows of the round trip. coati_tpu's fused round trip
        draws it for the batch padded to its power-of-two bucket (at least
        8 rows) and keeps the first b; drawing the same shape keeps this
        host noise stream aligned with it call after call."""
        bucket = max(8, 1 << (b - 1).bit_length())
        return self._sample_noise(scale, (bucket, self.embed_dim))[:b]

    def _tokens(self, token_indices) -> torch.Tensor:
        return torch.as_tensor(np.asarray(token_indices), dtype=torch.long, device=self.device)

    # ------------------------------------------------------------ encode
    @torch.no_grad()
    def encode_tokens(self, token_indices, tokenizer: TrieTokenizer) -> torch.Tensor:
        """(B, T) int tokens -> (B, embed_dim) hclip, on the model's device."""
        return coati.encode_tokens(
            self._compute, self.config, self._tokens(token_indices), tokenizer.stop_token
        )

    def encode_points(self, atoms, coords):
        raise NotImplementedError(_LATER_SLICE)

    def points_to_2d_batch(self, *args, **kwargs):
        raise NotImplementedError(_LATER_SLICE)

    # ---------------------------------------------------------- generate
    def _decode(
        self,
        h_token: torch.Tensor,
        tokenizer: TrieTokenizer,
        prefix_text: str,
        inv_temp: float,
        k: int,
        total_len: Optional[int],
        top_p: Optional[float] = None,
    ) -> np.ndarray:
        """Generate from injected clip tokens (B, D) behind `prefix_text`."""
        b = h_token.shape[0]
        prefix = tokenizer.tokenize_text(prefix_text, pad=False)
        total_len = total_len or self.config.n_seq
        tokens0 = torch.zeros((b, total_len), dtype=torch.long, device=self.device)
        tokens0[:, : len(prefix)] = torch.as_tensor(prefix, dtype=torch.long, device=self.device)
        out = generate_tokens(
            self._compute.xformer,
            self.config.xformer_config,
            self._generator,
            tokens0,
            torch.full((b,), len(prefix), dtype=torch.long, device=self.device),
            prefill_len=len(prefix),
            total_len=total_len,
            stop_token=tokenizer.stop_token,
            pad_token=tokenizer.pad_token,
            k=k,
            inv_temp=inv_temp,
            inj_payload=h_token,
            inject_token=tokenizer.unk_token,
            stage_widths=auto_stage_widths(len(prefix), total_len),
            top_p=top_p,
        )
        return out.cpu().numpy()

    @torch.no_grad()
    def hclip_to_2d_batch(
        self,
        h_clip,
        tokenizer: TrieTokenizer,
        fill_in_from: str = "[SMILES]",
        noise_scale: float = 0.0,
        inv_temp: float = 2.0,
        k: int = 100,
        do_suffix: bool = False,
        keep_special: bool = False,
        return_tokens: bool = False,
        top_p: Optional[float] = None,
    ):
        """Decode a batch of hclip vectors to SMILES. top_p: optional
        nucleus truncation within the top-k candidates; None = plain top-k."""
        if isinstance(h_clip, torch.Tensor):
            h_clip = h_clip.detach().float().cpu().numpy()
        h_clip = np.asarray(h_clip, dtype=np.float32)
        if noise_scale > 0:
            h_clip = h_clip + self._sample_noise(noise_scale, h_clip.shape)
        dtype = self.config.xformer_config.compute_dtype
        h = torch.tensor(h_clip, device=self.device).to(dtype)
        suffstr = "[SUFFIX][MIDDLE]" if do_suffix else ""
        toks = self._decode(
            coati.clip_to_special_token(self._compute, h), tokenizer,
            "[CLIP][UNK]" + fill_in_from + suffstr, inv_temp, k, None, top_p=top_p,
        )
        smiles = tokenizer.decode_batch(toks, special=keep_special)
        if return_tokens:
            return smiles, [list(map(int, row)) for row in toks]
        return smiles

    def hclip_to_2d(
        self,
        h_clip,
        tokenizer: TrieTokenizer,
        fill_in_from: str = "[SMILES]",
        noise_scale: float = 0.0,
        do_suffix: bool = False,
        inv_temp: float = 2.0,
        k: int = 100,
    ) -> str:
        """Single-vector decode."""
        h = np.asarray(h_clip, np.float32).reshape(1, -1)
        return self.hclip_to_2d_batch(
            h, tokenizer, fill_in_from, noise_scale, inv_temp, k, do_suffix
        )[0]

    @torch.no_grad()
    def smiles_to_2d_batch(
        self,
        token_indices,
        tokenizer: TrieTokenizer,
        fill_in_from: str = "[SMILES]",
        noise_scale: float = 0.0,
        inv_temp: float = 2.0,
        k: int = 100,
        keep_special: bool = False,
        return_embeddings: bool = False,
        total_len: Optional[int] = None,
    ):
        """Embed -> decode round trip: tokenized SMILES in, re-generated
        SMILES (and optionally the hclip embeddings, numpy) out, with no
        host hop between the encode and the decode."""
        tokens = self._tokens(token_indices)
        h = coati.encode_tokens(self._compute, self.config, tokens, tokenizer.stop_token)
        if noise_scale > 0:
            noise = self._fused_noise(noise_scale, h.shape[0])
            h_in = h + torch.as_tensor(noise, device=self.device).to(h.dtype)
        else:
            h_in = h
        toks = self._decode(
            coati.clip_to_special_token(self._compute, h_in), tokenizer,
            "[CLIP][UNK]" + fill_in_from, inv_temp, k, total_len,
        )
        smiles = tokenizer.decode_batch(toks, special=keep_special)
        if return_embeddings:
            return smiles, h.float().cpu().numpy()
        return smiles
