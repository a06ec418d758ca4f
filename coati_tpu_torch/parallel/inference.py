"""Data-parallel batched inference over several devices of one process.

PyTorch counterpart of coati_tpu/parallel/inference.py. coati_tpu shards a
batch over a mesh's data axis and runs one SPMD program; here there is one
replica of the model a device (devices named twice share one copy of the
weights), the rows are padded to a multiple of the device count with copies
of the first row and split evenly, each replica's call runs in its own
thread (launching on its device), and the outputs are put back in order.
Rows decode independently, so no device talks to another.

ShardedCOATI serves the COATI surface (encode_tokens, encode_points,
hclip_to_2d_batch) and ShardedCOATI2 the COATI2 one (encode_tokens,
smiles_to_coati_vec, hcoati_to_2d_batch). Host noise is drawn once for the
whole batch from numpy's default_rng(seed), as coati_tpu's sharded models
draw it; each replica samples from its own generator (seed + its index).
"""

from __future__ import annotations

import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch

from coati_tpu_torch.parallel.mesh import on_device
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


def pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Rows padded with copies of the first to a multiple of `multiple`."""
    extra = (-arr.shape[0]) % multiple
    if extra == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[:1], extra, axis=0)], axis=0)


class _ShardedInferenceBase:
    """One replica of `model` (a COATI or COATI2) on each of `devices`."""

    def __init__(self, model, devices: Sequence, seed: int = 0):
        if not devices:
            raise ValueError("name at least one device")
        self.model = model
        self.devices = [torch.device(d) for d in devices]
        self.n_devices = len(self.devices)
        self.device = self.devices[0]
        self.config = model.config
        self.embed_dim = model.embed_dim
        weights = {model.device: model.params}
        self.replicas = []
        for i, dev in enumerate(self.devices):
            if dev not in weights:
                weights[dev] = copy.deepcopy(model.params).to(dev)
            self.replicas.append(type(model)(weights[dev], model.config, seed=seed + i))
        self._noise = np.random.default_rng(seed)
        self._noise_lock = threading.Lock()  # numpy Generators are not thread-safe
        self._pool = ThreadPoolExecutor(self.n_devices, thread_name_prefix="replica")

    def _on(self, replica, fn, *args):
        with on_device(replica.device):
            return fn(replica, *args)

    def _map(self, fn, arr: np.ndarray) -> List:
        """fn(replica, its rows) for each replica, in order, on the padded,
        evenly split rows."""
        parts = np.split(pad_rows(arr, self.n_devices), self.n_devices)
        futures = [self._pool.submit(self._on, r, fn, part) for r, part in zip(self.replicas, parts)]
        return [f.result() for f in futures]

    def encode_tokens(self, token_indices, tokenizer: TrieTokenizer) -> torch.Tensor:
        """(B, T) tokens -> (B, embed_dim) embeddings on the first device."""
        tokens = np.asarray(token_indices)
        outs = self._map(lambda r, part: r.encode_tokens(part, tokenizer), tokens)
        return torch.cat([o.to(self.device) for o in outs])[: tokens.shape[0]]

    def _decode_embeddings(self, h, tokenizer: TrieTokenizer, fill_in_from: str = "[SMILES]",
                           noise_scale: float = 0.0, inv_temp: float = 2.0, k: int = 100,
                           do_suffix: bool = False, keep_special: bool = False, top_p=None,
                           return_tokens: bool = False):
        if isinstance(h, torch.Tensor):
            h = h.detach().float().cpu().numpy()
        h = np.asarray(h, np.float32)
        b = h.shape[0]
        if noise_scale > 0:
            # drawn once for the batch, so a call's noise does not depend on
            # how the rows are split
            with self._noise_lock:
                h = h + self._noise.normal(scale=noise_scale, size=h.shape).astype(np.float32)

        def decode(replica, part):
            return replica.vectors_to_2d_batch(part, tokenizer, fill_in_from, 0.0, inv_temp, k,
                                               do_suffix, keep_special, return_tokens=True,
                                               top_p=top_p)

        outs = self._map(decode, h)
        smiles = [s for out, _ in outs for s in out][:b]
        if return_tokens:
            return smiles, [row for _, rows in outs for row in rows][:b]
        return smiles


class ShardedCOATI(_ShardedInferenceBase):
    """COATI's inference surface over several devices."""

    def encode_points(self, atoms, coords) -> torch.Tensor:
        atoms = np.asarray(atoms)
        coords = np.asarray(coords, np.float32)
        both = np.concatenate([atoms.reshape(atoms.shape[0], -1).astype(np.float32),
                               coords.reshape(coords.shape[0], -1)], axis=1)
        n = atoms.shape[1]

        def encode(replica, part):
            return replica.encode_points(part[:, :n].astype(np.int64),
                                         part[:, n:].reshape(part.shape[0], n, 3))

        outs = self._map(encode, both)
        return torch.cat([o.to(self.device) for o in outs])[: atoms.shape[0]]

    def hclip_to_2d_batch(self, h_clip, tokenizer: TrieTokenizer, fill_in_from: str = "[SMILES]",
                          noise_scale: float = 0.0, inv_temp: float = 2.0, k: int = 100,
                          do_suffix: bool = False, keep_special: bool = False, top_p=None,
                          return_tokens: bool = False):
        """Decode embeddings to SMILES (and, with return_tokens, the token
        rows), the rows split over the replicas."""
        return self._decode_embeddings(h_clip, tokenizer, fill_in_from, noise_scale, inv_temp, k,
                                       do_suffix, keep_special, top_p, return_tokens)


class ShardedCOATI2(_ShardedInferenceBase):
    """COATI2's inference surface over several devices; conditioned
    generation passes its [PROPS]...[ENDPROPS][SMILES] block as
    fill_in_from, as COATI2.hcoati_to_2d_batch does."""

    def smiles_to_coati_vec(self, smiles, tokenizer: TrieTokenizer) -> np.ndarray:
        tokens = [tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles]
        return self.encode_tokens(np.asarray(tokens), tokenizer).float().cpu().numpy()

    def hcoati_to_2d_batch(self, h_coati, tokenizer: TrieTokenizer,
                           fill_in_from: str = "[SMILES]", noise_scale: float = 0.0,
                           inv_temp: float = 2.0, k: int = 100, do_suffix: bool = False,
                           keep_special: bool = False, top_p=None,
                           return_tokens: bool = False):
        return self._decode_embeddings(h_coati, tokenizer, fill_in_from, noise_scale, inv_temp, k,
                                       do_suffix, keep_special, top_p, return_tokens)


def shard_model(model, devices: Sequence, seed: int = 0):
    """ShardedCOATI2 for a COATI2, ShardedCOATI for a COATI."""
    cls = ShardedCOATI2 if hasattr(model, "hcoati_to_2d_batch") else ShardedCOATI
    return cls(model, devices, seed)
