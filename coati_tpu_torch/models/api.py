"""User-facing COATI model API.

The public surface of coati_tpu/models/api.py (itself the reference
e3gnn_smiles_clip_e2e's), on PyTorch:

    model, tokenizer = load_e3gnn_smiles_clip_e2e(doc_path)   # io.py; COATI2: load_coati2
    h = model.encode_tokens(tokens, tokenizer)                 # (B, D)
    h = model.encode_points(atoms, coords)                     # (B, D)
    smiles = model.hclip_to_2d_batch(h, tokenizer, noise_scale=0.3)
    smiles = model.smiles_to_2d_batch(tokens, tokenizer)       # round trip
    smiles = model.points_to_2d_batch(atoms, coords, tokenizer)

The model runs on the device its parameters lie on. Host noise is numpy
`default_rng(seed)`, as in the JAX package, so noisy decodes inject the
same embedding there and here; sampling draws from a torch.Generator on
the device. PyTorch runs eagerly, so the JAX package's batch bucketing
(which bounded XLA recompiles) is gone.
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import coati, trunks
from coati_tpu_torch.models.sampler import (
    auto_stage_widths,
    generate_prefix_batch,
    generate_tokens,
)
from coati_tpu_torch.ops.layers import cast_floats
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

# rows of (B, T, n_tok) float32 logits one likelihood pass may hold: 14 MB a
# row at T 250 with the 13,603-token vocab, twice over in the log-softmax
LIKELIHOOD_CHUNK = 64


def public_call(fn):
    """A public method under the span `api.<name>`: the root of a request
    when no span is open on the thread."""
    name = f"api.{fn.__name__}"

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        with tracing.span(name):
            return fn(self, *args, **kwargs)

    return call


class InjectedDecoder:
    """What COATI and COATI2 share: an nn.Module of parameters on a device,
    its compute-dtype copy, the host noise and device sampling streams, and
    decoding from an embedding injected over [UNK] behind a
    '[CLIP][UNK]...' prefix. A subclass says how tokens become an
    embedding (`_encode`) and an embedding the injected token
    (`_to_token`)."""

    def __init__(self, params: nn.Module, config, seed: int = 0):
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

    def _encode(self, tokens: torch.Tensor, tokenizer: TrieTokenizer) -> torch.Tensor:
        """(B, T) tokens on the device -> (B, embed_dim) embeddings."""
        raise NotImplementedError

    def _to_token(self, h: torch.Tensor) -> torch.Tensor:
        """Embeddings in the compute dtype -> the injected tokens."""
        raise NotImplementedError

    @torch.no_grad()
    def _clip_token(self, h) -> torch.Tensor:
        """An embedding (tensor or array) -> the injected token, in the
        compute dtype on the model's device."""
        dtype = self.config.xformer_config.compute_dtype
        if not isinstance(h, torch.Tensor):
            h = torch.tensor(np.asarray(h, dtype=np.float32))
        return self._to_token(h.to(self.device, dtype))

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
        with tracing.span("to_host"):
            out = out.cpu().numpy()
            trunks.publish_counters(self._compute.xformer)
            return out

    # ------------------------------------------------------------ encode
    @public_call
    @torch.no_grad()
    def encode_tokens(self, token_indices, tokenizer: TrieTokenizer) -> torch.Tensor:
        """(B, T) int tokens -> (B, embed_dim) embeddings, on the model's device."""
        with tracing.span("encode"):
            return self._encode(self._tokens(token_indices), tokenizer)

    # ---------------------------------------------------------- generate
    @public_call
    @torch.no_grad()
    def vectors_to_2d_batch(
        self,
        h,
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
        """Decode a batch of embeddings (tensor or array) to SMILES behind
        '[CLIP][UNK]' + fill_in_from, with host noise of `noise_scale` added
        first. top_p: optional nucleus truncation within the top-k
        candidates; None = plain top-k."""
        if isinstance(h, torch.Tensor):
            with tracing.span("to_host"):
                h = h.detach().float().cpu().numpy()
        h = np.asarray(h, dtype=np.float32)
        if noise_scale > 0:
            h = h + self._sample_noise(noise_scale, h.shape)
        suffstr = "[SUFFIX][MIDDLE]" if do_suffix else ""
        with tracing.span("encode"):
            h_token = self._clip_token(h)
        toks = self._decode(
            h_token, tokenizer,
            "[CLIP][UNK]" + fill_in_from + suffstr, inv_temp, k, None, top_p=top_p,
        )
        with tracing.span("detokenize"):
            smiles = tokenizer.decode_batch(toks, special=keep_special)
        if return_tokens:
            return smiles, [list(map(int, row)) for row in toks]
        return smiles

    def vector_to_2d(
        self,
        h,
        tokenizer: TrieTokenizer,
        fill_in_from: str = "[SMILES]",
        noise_scale: float = 0.0,
        do_suffix: bool = False,
        inv_temp: float = 2.0,
        k: int = 100,
    ) -> str:
        """Single-vector decode."""
        h = np.asarray(h, np.float32).reshape(1, -1)
        return self.vectors_to_2d_batch(
            h, tokenizer, fill_in_from, noise_scale, inv_temp, k, do_suffix
        )[0]

    @public_call
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
        SMILES (and optionally the embeddings, numpy) out, with no host hop
        between the encode and the decode; conditioned prefixes go through
        `fill_in_from`."""
        with tracing.span("encode"):
            h = self._encode(self._tokens(token_indices), tokenizer)
            h_in = h
            if noise_scale > 0:
                noise = self._fused_noise(noise_scale, h.shape[0])
                h_in = h + torch.as_tensor(noise, device=self.device).to(h.dtype)
            h_token = self._to_token(h_in)
        toks = self._decode(
            h_token, tokenizer, "[CLIP][UNK]" + fill_in_from, inv_temp, k, total_len,
        )
        with tracing.span("detokenize"):
            smiles = tokenizer.decode_batch(toks, special=keep_special)
        if return_embeddings:
            with tracing.span("to_host"):
                return smiles, h.float().cpu().numpy()
        return smiles


class COATI(InjectedDecoder):
    """Composite CLIP model: parameters + config + entry points."""

    def _encode(self, tokens: torch.Tensor, tokenizer: TrieTokenizer) -> torch.Tensor:
        return coati.encode_tokens(self._compute, self.config, tokens, tokenizer.stop_token)

    def _to_token(self, h: torch.Tensor) -> torch.Tensor:
        return coati.clip_to_special_token(self._compute, h)

    @public_call
    @torch.no_grad()
    def encode_points(self, atoms, coords) -> torch.Tensor:
        """(B, N) atomic numbers (0 = padding) and (B, N, 3) coordinates ->
        (B, embed_dim) hclip, on the model's device."""
        with tracing.span("encode"):
            atoms = torch.as_tensor(np.asarray(atoms).astype(np.int64), device=self.device)
            coords = torch.as_tensor(np.asarray(coords, dtype=np.float32), device=self.device)
            return coati.encode_points(self._compute, self.config, atoms, coords)

    hclip_to_2d_batch = InjectedDecoder.vectors_to_2d_batch
    hclip_to_2d = InjectedDecoder.vector_to_2d

    @public_call
    def points_to_2d_batch(
        self,
        atom_batch,
        coords_batch,
        tokenizer: TrieTokenizer,
        fill_in_from: str = "[SMILES]",
        noise_scale: float = 0.0,
        do_suffix: bool = False,
        inv_temp: float = 2.0,
        k: int = 100,
        keep_special: bool = False,
    ):
        """Point clouds in, SMILES decoded from their embeddings out."""
        h_clip = self.encode_points(atom_batch, coords_batch)
        return self.hclip_to_2d_batch(
            h_clip, tokenizer, fill_in_from, noise_scale, inv_temp, k, do_suffix, keep_special
        )

    def points_to_2d(self, atoms, coords, tokenizer, **kw) -> str:
        atoms = np.asarray(atoms).reshape(1, -1)
        coords = np.asarray(coords, np.float32).reshape(1, -1, 3)
        return self.points_to_2d_batch(atoms, coords, tokenizer, do_suffix=True, **kw)[0]

    @public_call
    @torch.no_grad()
    def complete_batch(
        self,
        prefixes: Sequence[str],
        tokenizer: TrieTokenizer,
        inv_temp: float = 2.0,
        k: int = 100,
        keep_special: bool = False,
        de_fim: bool = True,
    ) -> List[str]:
        """Text-prefix-conditioned generation; prefixes may differ in length."""
        toks = generate_prefix_batch(
            self._compute.xformer,
            self.config.xformer_config,
            self._generator,
            [tokenizer.tokenize_text(p, pad=False) for p in prefixes],
            stop_token=tokenizer.stop_token,
            pad_token=tokenizer.pad_token,
            k=k,
            inv_temp=inv_temp,
        )
        with tracing.span("to_host"):
            toks = toks.cpu().numpy()
        with tracing.span("detokenize"):
            return tokenizer.decode_batch(toks, special=keep_special, de_fim=de_fim)

    # ------------------------------------------------- fingerprint heads
    @torch.no_grad()
    def get_fp_pred_v2(self, token_indices, tokenizer: TrieTokenizer, fp_name: str) -> torch.Tensor:
        """Fingerprint logits from the SMILES clip token."""
        h_tok = self._clip_token(self.encode_tokens(token_indices, tokenizer))
        return coati.fp_predictions(self._compute, self.config, h_tok)[fp_name]

    @torch.no_grad()
    def get_fp_pred(
        self, token_indices, tokenizer: TrieTokenizer, atoms, coords, fp_name: str
    ) -> torch.Tensor:
        """Joint smiles/point fingerprint logits."""
        h_s = self._clip_token(self.encode_tokens(token_indices, tokenizer))
        h_p = self._clip_token(self.encode_points(atoms, coords))
        return coati.fp_predictions(self._compute, self.config, (h_s + h_p) / 2.0)[fp_name]

    # --------------------------------------------- graph-token generation
    def smiles_to_graph_batch(
        self, smiles: Sequence[str], tokenizer: TrieTokenizer,
        inv_temp: float = 2.0, k: int = 100,
    ) -> List[str]:
        """Generate [GRAPH] token strings conditioned on SMILES prefixes."""
        prefixes = ["[PREFIX][SMILES]" + s + "[GRAPH][SUFFIX][MIDDLE]" for s in smiles]
        return self.complete_batch(
            prefixes, tokenizer, inv_temp=inv_temp, k=k, keep_special=True, de_fim=False
        )

    def smiles_to_graph(self, smiles: str, tokenizer, inv_temp=2.0, k=100) -> str:
        return self.smiles_to_graph_batch([smiles], tokenizer, inv_temp, k)[0]

    def prefix_generate_batch(
        self, prefixes: Sequence[str], tokenizer: TrieTokenizer,
        inv_temp: float = 2.0, k: int = 100,
        keep_special: bool = False, de_fim: bool = True,
    ) -> List[str]:
        """FIM-style prefix completion."""
        return self.complete_batch(
            ["[PREFIX]" + p + "[SUFFIX][MIDDLE]" for p in prefixes],
            tokenizer, inv_temp=inv_temp, k=k, keep_special=keep_special, de_fim=de_fim,
        )

    # -------------------------------------------------------- likelihood
    @torch.no_grad()
    def _likelihood(self, tokens: np.ndarray, y_next: np.ndarray, h_token, unk_token: int):
        """tokens_likelihood over the batch in chunks of LIKELIHOOD_CHUNK
        rows, which bounds the (rows, T, n_tok) logits; rows are
        independent, so the result does not depend on the chunk."""
        out = []
        for s in range(0, tokens.shape[0], LIKELIHOOD_CHUNK):
            r = slice(s, s + LIKELIHOOD_CHUNK)
            out.append(coati.tokens_likelihood(
                self._compute, self.config, self._tokens(tokens[r]), self._tokens(y_next[r]),
                h_token[r], unk_token,
            ))
        return torch.cat(out)

    def hclip_and_tokens_to_likelihood(self, hclip, smiles: str, tokenizer: TrieTokenizer):
        """Summed NLL that hclip decodes to `smiles`; a (1,) tensor."""
        ids = tokenizer.tokenize_text(
            "[CLIP][UNK][SMILES][SUFFIX][MIDDLE]" + smiles + "[STOP]", pad=False
        )
        tokens = np.asarray([ids], np.int64)
        y_next = np.zeros_like(tokens)
        y_next[:, :-1] = tokens[:, 1:]
        for t in (
            tokenizer.clip_token,
            tokenizer.pad_token,
            tokenizer.smiles_token,
            tokenizer.unk_token,
            tokenizer.suffix_token,
            tokenizer.middle_token,
        ):
            y_next[y_next == t] = -1
        if isinstance(hclip, torch.Tensor):
            hclip = hclip.detach().float().cpu().numpy()
        h_token = self._clip_token(np.asarray(hclip, np.float32).reshape(1, -1))
        return self._likelihood(tokens, y_next, h_token, tokenizer.unk_token)

    def batch_smiles_to_s2s_likelihood(
        self, smiles: List[str], tokenizer: TrieTokenizer
    ) -> Tuple[torch.Tensor, np.ndarray]:
        """SMILES -> hclip -> NLL of decoding back to the same SMILES.
        Returns (nll over tokenizable rows, mask over the input)."""
        rows, mask = [], []
        for smi in smiles:
            try:
                ids = tokenizer.tokenize_text(smi + "[STOP]", pad=False)
                if len(ids) <= tokenizer.n_seq - 5:
                    rows.append(ids)
                    mask.append(True)
                else:
                    mask.append(False)
            except KeyError:
                mask.append(False)
        mask = np.asarray(mask, bool)
        if not rows:
            return torch.zeros((0,), device=self.device), mask
        width = max(len(r) for r in rows)

        enc_tokens = np.zeros((len(rows), width + 1), np.int64)
        enc_tokens[:, 0] = tokenizer.smiles_token
        dec_tokens = np.zeros((len(rows), width + 5), np.int64)
        dec_tokens[:, :5] = [
            tokenizer.clip_token,
            tokenizer.unk_token,
            tokenizer.smiles_token,
            tokenizer.suffix_token,
            tokenizer.middle_token,
        ]
        for i, r in enumerate(rows):
            enc_tokens[i, 1 : 1 + len(r)] = r
            dec_tokens[i, 5 : 5 + len(r)] = r

        h_token = self._clip_token(self.encode_tokens(enc_tokens, tokenizer))

        y_next = np.zeros_like(dec_tokens)
        y_next[:, :-1] = dec_tokens[:, 1:]
        y_next[:, :4] = -1
        y_next[:, -1] = -1
        y_next[y_next == tokenizer.pad_token] = -1
        return self._likelihood(dec_tokens, y_next, h_token, tokenizer.unk_token), mask

    # ------------------------------------------------------------- train
    def forward(
        self,
        raw_tokens,
        augmented_tokens,
        atoms,
        coords,
        tokenizer: TrieTokenizer,
        p_clip_emb_smi: float = 0.4,
    ):
        """Training forward (h_e3gnn, h_smiles, logits, bad_rows) of host
        arrays or tensors, on the model's device: each row's injected clip
        token is the point embedding's with probability 1 - p_clip_emb_smi,
        drawn from the model's generator. Autograd records it, so a loss of
        its outputs reaches the float32 parameters."""
        return coati.forward(
            self.params,
            self.config,
            self._generator,
            self._tokens(raw_tokens),
            self._tokens(augmented_tokens),
            self._tokens(np.asarray(atoms).astype(np.int64)),
            torch.as_tensor(np.asarray(coords, dtype=np.float32), device=self.device),
            tokenizer.stop_token,
            tokenizer.unk_token,
            p_clip_emb_smi,
        )

    # the reference's DDP variant of forward; on one device the same function
    forward_dist = forward
