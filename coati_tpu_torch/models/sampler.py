"""Autoregressive sampler with KV cache.

PyTorch counterpart of coati_tpu/models/sampler.py: the prefix runs once
through `prefill` into a KV cache, then one `decode_step` per token, with
the reference's per-row semantics: stopped rows emit [PAD]; rows whose own
prefix extends past a position keep their prefix token there; rows that
never stop get [STOP] forced at the last written position; the loop ends
early once every row has stopped. ClipCap-style payload injection over
[UNK] happens in the prefill.

Sampling distribution: multinomial(softmax(top-k logits * inv_temp)).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    decode_step,
    make_empty_cache,
    prefill,
)
from coati_tpu_torch.ops.layers import cast_floats, linear
from coati_tpu_torch.ops.sampling import sample_top_k


def auto_stage_widths(prefill_len: int, total_len: int) -> Optional[tuple]:
    """Default staged-decode schedule: ~6 stages in multiples of 16."""
    if total_len < 64:
        return None
    step = max(16, ((total_len + 5) // 6 + 15) // 16 * 16)
    widths = [w for w in range(step, total_len, step) if w > prefill_len]
    widths.append(total_len)
    return tuple(widths) if len(widths) > 1 else None


def _check_stage_widths(stage_widths, prefill_len: int, total_len: int) -> tuple:
    if stage_widths is None:
        stage_widths = (total_len,)
    stage_widths = tuple(min(w, total_len) for w in stage_widths)
    if stage_widths[-1] != total_len or any(
        stage_widths[i] >= stage_widths[i + 1] for i in range(len(stage_widths) - 1)
    ):
        raise ValueError(f"stage_widths {stage_widths} must increase and end at {total_len}")
    if prefill_len > stage_widths[0]:
        raise ValueError(f"prefill_len {prefill_len} exceeds the first stage {stage_widths[0]}")
    return stage_widths


@torch.no_grad()
def generate_tokens(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    generator: Optional[torch.Generator],
    prefix_tokens: torch.Tensor,  # (B, T_total) prefix-initialized, 0-padded
    prefix_len: torch.Tensor,  # (B,) per-row prefix lengths
    *,
    prefill_len: int,  # min prefix length (prefill region)
    total_len: int,  # output width (<= cfg.n_seq)
    stop_token: int,
    pad_token: int = 0,
    k: int = 100,
    inv_temp: float = 2.0,
    inj_payload: Optional[torch.Tensor] = None,  # (B, D)
    inject_token: Optional[int] = None,
    stage_widths: Optional[Sequence[int]] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Returns (B, total_len) int64 tokens including the prefix.

    stage_widths keeps the JAX package's meaning and results: there the
    cache grows through the stages, because its XLA decode read the whole
    cache width every step. The port's decode kernel reads only positions
    [0, pos], so one cache of the final width gives the same tokens; it is
    allocated once, and the stages only bound the loop."""
    if not 1 <= prefill_len <= total_len <= cfg.n_seq:
        raise ValueError(
            f"need 1 <= prefill_len ({prefill_len}) <= total_len ({total_len}) <= n_seq ({cfg.n_seq})"
        )
    stage_widths = _check_stage_widths(stage_widths, prefill_len, total_len)
    b = prefix_tokens.shape[0]
    device = prefix_tokens.device
    tokens = prefix_tokens.to(torch.long).clone()
    prefix_len = prefix_len.to(device)
    params = cast_floats(params, cfg.compute_dtype)  # once, not per step

    cache = make_empty_cache(cfg, b, width=total_len, device=device)
    hidden, cache = prefill(
        params, cfg, tokens[:, :prefill_len],
        injection=inj_payload,
        inject_token=inject_token if inj_payload is not None else None,
        cache=cache,
    )
    # distribution for the token at position `prefill_len`
    last_logits = linear(hidden[:, -1], params.lm_head.weight).float()
    # a row is "stopped" once any written token equals [STOP]
    stopped = (tokens[:, :prefill_len] == stop_token).any(dim=1)

    pos = prefill_len
    for width in stage_widths:
        # `stopped.all()` is read on the host: one device sync per step,
        # the price of the early exit
        while pos < width and not bool(stopped.all()):
            sampled = sample_top_k(generator, last_logits, k, inv_temp, top_p=top_p)
            sampled = torch.where(stopped, pad_token, sampled)
            tok = torch.where(pos < prefix_len, tokens[:, pos], sampled)
            tokens[:, pos] = tok
            stopped |= tok == stop_token
            logits, cache = decode_step(params, cfg, tok, pos, cache)
            last_logits = logits.float()
            pos += 1

    # force [STOP] at the last written position for rows that never stopped
    last = max(pos - 1, 0)
    tokens[:, last] = torch.where(stopped, tokens[:, last], stop_token)
    return tokens


def generate_with_injection_batch(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    generator: Optional[torch.Generator],
    prefix: list,
    inj_payload: torch.Tensor,  # (B, D)
    *,
    stop_token: int,
    pad_token: int = 0,
    unk_token: int,
    k: int = 100,
    inv_temp: float = 2.0,
    total_len: Optional[int] = None,
) -> torch.Tensor:
    """Common-prefix batched generation with payload injection over [UNK]."""
    b = inj_payload.shape[0]
    device = inj_payload.device
    total_len = total_len or cfg.n_seq
    p = len(prefix)
    tokens = torch.zeros((b, total_len), dtype=torch.long, device=device)
    tokens[:, :p] = torch.as_tensor(prefix, dtype=torch.long, device=device)
    return generate_tokens(
        params, cfg, generator, tokens,
        torch.full((b,), p, dtype=torch.long, device=device),
        prefill_len=p, total_len=total_len, stop_token=stop_token,
        pad_token=pad_token, k=k, inv_temp=inv_temp,
        inj_payload=inj_payload, inject_token=unk_token,
    )
