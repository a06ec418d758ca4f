"""Sequence parallelism: ring attention over a `seq` mesh axis.

PyTorch counterpart of coati_tpu/parallel/sp.py. Activations are split
along the sequence over the `seq` axis of a (data, seq) mesh; attention is
the ring algorithm: the K / V blocks rotate around the ring
(comm.ring_permute, i -> i + 1 mod S) while each rank streams them into a
flash-style accumulator (running max, rescaled partial sums). Rank s owns
query block s, positions [s T / S, (s + 1) T / S); K / V block j counts in
full when j < s, under the causal triangle when j == s, and not at all
when j > s. Everything else (LayerNorm, MLP, embedding, logits) acts on
each position alone and runs on the local shard unchanged, with the
transformer's own block functions; rotary takes absolute positions from
the shard's offset.

The per-block attention is plain PyTorch, as coati_tpu's is plain XLA: no
Pallas kernel computes it there. ring_permute's backward rotates the K / V
cotangents back around the ring.

Entry points take a data rank's rows over the WHOLE sequence (B, T) and
slice their own shard; T must divide by the seq axis and fit the rotary
tables (`_check_seq`, ValueError otherwise).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from coati_tpu_torch.models import coati as F
from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    _block_tail,
    _lm_head,
    embed_tokens,
)
from coati_tpu_torch.ops.layers import cast_floats, layer_norm, linear
from coati_tpu_torch.ops.rotary import apply_rotary, rotary_tables
from coati_tpu_torch.parallel.comm import (
    all_reduce_,
    all_reduce_sum,
    gather_rows,
    group_rank,
    group_size,
    pmin,
    ring_permute,
)
from coati_tpu_torch.parallel.mesh import axis_groups, make_axis_mesh

_NEG_INF = -1e30


def make_sp_mesh(n_devices: Optional[int] = None, seq: int = 2,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(data = n / seq) x (seq); a seq group holds neighbouring ranks."""
    return make_axis_mesh("seq", seq, n_devices, device_type)


class _Seq:
    """The (data, seq) groups of a mesh and this rank's place in them."""

    def __init__(self, mesh: DeviceMesh):
        (self.data, self.seq, self.n_data, self.n_shards, self.data_rank,
         self.shard) = axis_groups(mesh, "seq")


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                          shard: Optional[int] = None) -> torch.Tensor:
    """Causal attention with the sequence split over `group` (rank s of the
    group holding block s). q, k, v: (B, T_local, H, Dh), rotary applied at
    absolute positions. Returns (B, T_local, H, Dh): this block's rows of
    causal attention over the whole sequence (1/sqrt(Dh) scale, float32
    softmax, -1e30 mask, as ops/attention.py)."""
    n_shards = group_size(group)
    s = group_rank(group) if shard is None else shard
    b, t, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    tril = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    full = torch.ones_like(tril)
    none = torch.zeros_like(tril)
    m = torch.full((b, h, t), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, h, t, dh), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for r in range(n_shards):
        j = (s - r) % n_shards  # the block held after r rotations
        mask = (full if j < s else tril if j == s else none)[None, None]
        scores = torch.einsum("bthd,bshd->bhts", q, k_cur).float() * scale
        scores = torch.where(mask, scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        # masked again after exp: while m_new is still the -1e30 floor (a
        # block past the diagonal before any real one), exp(0) would add 1s
        p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p, v_cur.float())
        m = m_new
        if r < n_shards - 1:  # the last rotation would bring the home block back
            k_cur, v_cur = ring_permute(k_cur, group), ring_permute(v_cur, group)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(v.dtype)


def _sp_block(x, blk, cfg: TransformerConfig, cos_loc, sin_loc, group):
    """One block over a local sequence shard: the transformer's block with
    ring attention in place of the kernel."""
    b, t, d = x.shape
    h, dh = cfg.n_head, cfg.head_dim
    y = layer_norm(x, blk.ln_1.weight, blk.ln_1.bias)
    q, k, v = linear(y, blk.attn.c_attn.weight, blk.attn.c_attn.bias).split(d, dim=-1)
    q = apply_rotary(q.reshape(b, t, h, dh), cos_loc[:, None, :], sin_loc[:, None, :])
    k = apply_rotary(k.reshape(b, t, h, dh), cos_loc[:, None, :], sin_loc[:, None, :])
    attn = ring_causal_attention(q, k, v.reshape(b, t, h, dh), group).reshape(b, t, d)
    return _block_tail(x, attn, blk)


def _sp_hidden(params: SmilesTransformer, cfg: TransformerConfig, tokens: torch.Tensor,
               seq: _Seq, injection=None, inject_token=None) -> torch.Tensor:
    """The local shard's forward: tokens (B, T_local) -> final-LN hidden
    (B, T_local, D), rotary at the shard's absolute positions."""
    t = tokens.shape[1]
    params = cast_floats(params, cfg.compute_dtype)
    cos, sin = rotary_tables(cfg.n_seq, cfg.head_dim, device=tokens.device)
    off = seq.shard * t
    cos_loc = cos[off:off + t].to(cfg.compute_dtype)
    sin_loc = sin[off:off + t].to(cfg.compute_dtype)
    x = embed_tokens(params, cfg, tokens, injection, inject_token)
    remat = cfg.remat and torch.is_grad_enabled()
    for blk in params.transformer.h:
        if remat:
            x = checkpoint(_sp_block, x, blk, cfg, cos_loc, sin_loc, seq.seq, use_reentrant=False)
        else:
            x = _sp_block(x, blk, cfg, cos_loc, sin_loc, seq.seq)
    lnf = params.transformer.ln_f
    return layer_norm(x, lnf.weight, lnf.bias)


def _check_seq(tokens: torch.Tensor, cfg: TransformerConfig, n_shards: int) -> None:
    """The whole length must split evenly over the seq axis and fit the
    rotary tables: a shard offset past n_seq would read no rotary rows at
    all, or the wrong ones."""
    t = tokens.shape[1]
    if t % n_shards:
        raise ValueError(f"sequence length {t} must divide evenly into {n_shards} seq shards")
    if t > cfg.n_seq:
        raise ValueError(f"sequence length {t} exceeds cfg.n_seq={cfg.n_seq}; rotary tables "
                         "only cover n_seq positions")


def _local(x: torch.Tensor, seq: _Seq) -> torch.Tensor:
    """This shard's columns of (B, T, ...)."""
    t = x.shape[1] // seq.n_shards
    return x[:, seq.shard * t:(seq.shard + 1) * t]


def make_sp_forward_logits(mesh: DeviceMesh, cfg: TransformerConfig, model: SmilesTransformer,
                           inject_token: Optional[int] = None):
    """fn(tokens (B, T)[, injection (B, D)]) -> logits (B, T, V) of this data
    rank's rows, the shards' logits gathered over seq; equal to
    transformer.forward_logits."""
    seq = _Seq(mesh)

    def fn(tokens, injection=None):
        _check_seq(tokens, cfg, seq.n_shards)
        hidden = _sp_hidden(model, cfg, _local(tokens, seq), seq,
                            injection if inject_token is not None else None, inject_token)
        logits = _lm_head(cast_floats(model, cfg.compute_dtype), cfg, hidden)
        return gather_rows(logits.transpose(0, 1).contiguous(), seq.seq).transpose(0, 1)

    return fn


def make_sp_train_step(mesh: DeviceMesh, cfg: TransformerConfig, model: SmilesTransformer,
                       optimizer):
    """The sequence-parallel AR train step: step(tokens (B, T), y_next
    (B, T)) -> the global mean token loss (0-d tensor), one optimizer step
    on the masked next-token cross-entropy (ignore_index -1) of this data
    rank's rows, updating `model` (whole on every rank) in place.

    The local loss is the shard's unnormalized cross-entropy sum, with no
    sum over ranks inside it (ring_permute's backward routes the K / V
    cotangents back around the ring); the gradients and the loss and count
    sums are then summed over (data, seq) and divided by the global count
    of valid tokens: the single-device step's gradient."""
    seq = _Seq(mesh)

    def step(tokens, y_next):
        _check_seq(tokens, cfg, seq.n_shards)
        hidden = _sp_hidden(model, cfg, _local(tokens, seq), seq)
        logits = _lm_head(cast_floats(model, cfg.compute_dtype), cfg, hidden)
        total, count = F.nll_sum_and_count(logits.reshape(-1, logits.shape[-1]),
                                           _local(y_next, seq).reshape(-1))
        total.backward()
        params = list(model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        sums = torch.stack([total.detach(), count.to(total.dtype)])
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [sums])
        for group in (seq.seq, seq.data):
            all_reduce_(flat, group)
        loss_sum, n_valid = flat[-2], flat[-1].clamp_min(1.0)
        grads = flat[:-2] / n_valid
        torch._foreach_copy_([p.grad for p in params],
                             [g.view_as(p) for g, p in
                              zip(grads.split([p.numel() for p in params]), params)])
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss_sum / n_valid

    return step


def make_sp_encode(mesh: DeviceMesh, cfg: TransformerConfig, model: SmilesTransformer,
                   stop_token: int):
    """fn(tokens (B, T)) -> (B, D): the hidden state at each row's FIRST
    [STOP], as transformer.encode: each shard's first stop at its absolute
    position, the minimum over the shards (comm.pmin) the row's first, a
    row without one falling back to position 0; the owning shard
    contributes the row and a sum over seq assembles it."""
    seq = _Seq(mesh)
    big = 2 ** 30

    @torch.no_grad()
    def fn(tokens):
        _check_seq(tokens, cfg, seq.n_shards)
        local_tokens = _local(tokens, seq)
        t = local_tokens.shape[1]
        hidden = _sp_hidden(model, cfg, local_tokens, seq)
        off = seq.shard * t
        is_stop = local_tokens == stop_token
        first = is_stop.int().argmax(dim=1)
        pos = torch.where(is_stop.any(dim=1), off + first, big)
        pos = pmin(pos, seq.seq)
        pos = torch.where(pos >= big, 0, pos)
        local = pos - off
        inside = (local >= 0) & (local < t)
        rows = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                      local.clamp(0, t - 1)] * inside[:, None].to(hidden.dtype)
        return all_reduce_sum(rows, seq.seq)

    return fn
