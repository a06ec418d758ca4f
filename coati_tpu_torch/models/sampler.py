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

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import decode_graph, trunks
from coati_tpu_torch.models.transformer import SmilesTransformer, TransformerConfig
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


def _check_stage_widths(stage_widths, prefill_len: int, total_len: int) -> None:
    if stage_widths is None:
        return
    stage_widths = tuple(min(w, total_len) for w in stage_widths)
    if stage_widths[-1] != total_len or any(
        stage_widths[i] >= stage_widths[i + 1] for i in range(len(stage_widths) - 1)
    ):
        raise ValueError(f"stage_widths {stage_widths} must increase and end at {total_len}")
    if prefill_len > stage_widths[0]:
        raise ValueError(f"prefill_len {prefill_len} exceeds the first stage {stage_widths[0]}")


def live_row_steps(tokens: torch.Tensor, stop_token: int, first: int) -> int:
    """Decode steps from position `first` up to each row's first [STOP]
    (the step that writes it left out), summed over the rows."""
    is_stop = tokens == stop_token
    end = torch.where(is_stop.any(1), is_stop.int().argmax(1), tokens.shape[1])
    return int((end - first).clamp(min=0).sum())


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
    [0, pos], so one cache of the final width and one loop give the same
    tokens; the stages are only checked."""
    if not 1 <= prefill_len <= total_len <= cfg.n_seq:
        raise ValueError(
            f"need 1 <= prefill_len ({prefill_len}) <= total_len ({total_len}) <= n_seq ({cfg.n_seq})"
        )
    _check_stage_widths(stage_widths, prefill_len, total_len)
    b = prefix_tokens.shape[0]
    device = prefix_tokens.device
    compute = cast_floats(params, cfg.compute_dtype)  # once, not per step
    trunk = trunks.of(cfg)
    with decode_graph.stepper(params, compute, cfg, b, prefill_len, total_len,
                              device) as stepper:
        with tracing.span("prefill"):
            tokens = prefix_tokens.to(torch.long).clone()
            prefix_len = prefix_len.to(device)
            hidden, _ = trunk.prefill(
                compute, cfg, tokens[:, :prefill_len],
                injection=inj_payload,
                inject_token=inject_token if inj_payload is not None else None,
                cache=stepper.cache,
            )
            # distribution for the token at position `prefill_len`
            last_logits = linear(hidden[:, -1], compute.lm_head.weight).float()
            # a row is "stopped" once any written token equals [STOP]
            stopped = (tokens[:, :prefill_len] == stop_token).any(dim=1)

        with tracing.span("decode"):
            # `stopped.all()` is read on the host before the first step and
            # at the end of each: one device sync per step, the price of the
            # early exit (under a graph it waits for the step's sampling
            # only, not for its replay)
            with tracing.span("decode.stop_read"):
                done = bool(stopped.all())
            pos = prefill_len
            stepper.start(pos)
            while pos < total_len and not done:
                with tracing.span("decode.step"):
                    with tracing.span("decode.sample"):
                        sampled = sample_top_k(generator, last_logits, k, inv_temp, top_p=top_p)
                        sampled = torch.where(stopped, pad_token, sampled)
                        tok = torch.where(pos < prefix_len, tokens[:, pos], sampled)
                        tokens[:, pos] = tok
                        stopped |= tok == stop_token
                    with tracing.span("decode.forward"):
                        stepper.post_stopped(stopped)
                        last_logits = stepper.step(tok)
                    pos += 1
                    with tracing.span("decode.stop_read"):
                        done = stepper.read_stopped()

            # force [STOP] at the last written position for rows that never stopped
            last = max(pos - 1, 0)
            tokens[:, last] = torch.where(stopped, tokens[:, last], stop_token)
    if tracing.started():
        tracing.count("decode.row_steps", b * (pos - prefill_len))
        tracing.count("decode.live_row_steps",
                      live_row_steps(tokens[:, :pos], stop_token, prefill_len))
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


def generate_prefix_batch(
    params: SmilesTransformer,
    cfg: TransformerConfig,
    generator: Optional[torch.Generator],
    prefixes: Sequence[Sequence[int]],
    *,
    stop_token: int,
    pad_token: int = 0,
    k: int = 100,
    inv_temp: float = 2.0,
    total_len: Optional[int] = None,
) -> torch.Tensor:
    """Generation behind token prefixes of different lengths (the
    reference's generate_topk_batch): the prefill covers the shortest
    prefix, and each longer row keeps its own prefix tokens through the
    decode steps. Returns (B, total_len) int64 tokens on the device of
    `params` (a compute-dtype copy from cast_floats registers no
    parameters, so the device is its lm_head's)."""
    device = params.lm_head.weight.device
    total_len = total_len or cfg.n_seq
    lens = [len(pf) for pf in prefixes]
    tokens = torch.zeros((len(prefixes), total_len), dtype=torch.long)
    for i, pf in enumerate(prefixes):
        tokens[i, : len(pf)] = torch.as_tensor(list(pf), dtype=torch.long)
    return generate_tokens(
        params, cfg, generator, tokens.to(device),
        torch.as_tensor(lens, dtype=torch.long, device=device),
        prefill_len=max(1, min(lens)), total_len=total_len, stop_token=stop_token,
        pad_token=pad_token, k=k, inv_temp=inv_temp,
    )
