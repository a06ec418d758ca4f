"""A mixture-of-experts layer told which experts it holds (DeepSeek-V2's).

The router scores every token against all `n_routed` experts at its
published width, softmax in float32, and picks the `top_k` best greedily,
the lower index winning a tie (a stable sort). A layer split over chips by
expert (expert parallelism) holds experts [first, first + n_held) here: it
computes, for every (token, held expert) pair among the picks, p_e E_e(x),
and the shared expert for every token. No pair is dropped and nothing
stands in for the experts held elsewhere: their part of the sum is left
out, as it would be added by the chips that hold them.

On the card nothing here reads the device from the host, so a decode step
through it can be captured as a CUDA graph: the B x top_k picks are put in
expert order by a fixed-size stable sort (picks of experts held elsewhere
sort last), each held expert's end offset in that order is found on the
card (searchsorted), and the two grouped products of the SwiGLU experts
read those offsets there (`torch._grouped_mm`: tensor cores, one launch
for all the held experts, rows past the last offset untouched). The
combine is a fixed-order sum over each token's top_k slots, with no
atomics, so it repeats bit for bit. For CPU tensors the grouped product is
a loop over the held experts (`grouped_swiglu_plain`).

Counters (`MoeCounters`): per held expert the tokens routed to it, summed
on the card over every pass, and per pass the held experts' highest count
over their mean; the caller reads them when its results go to the host
(models/mla_moe.py `publish_counters`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from coati_tpu_torch.common import tracing
from coati_tpu_torch.ops.layers import linear


def route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """(weights (N, top_k) float32, experts (N, top_k) int64): softmax of
    the router's logits over all experts in float32, the top_k largest in
    order, the lower index first among equals."""
    p = linear(x, w_router).float().softmax(-1)
    weights, experts = torch.sort(p, dim=-1, descending=True, stable=True)
    return weights[:, :top_k], experts[:, :top_k]


def dispatch(experts: torch.Tensor, first: int, n_held: int):
    """The picks (N, top_k) in expert order: (order (N * top_k,) int64, the
    index of each sorted pick among the flattened picks; ends (n_held,)
    int32, where each held expert's picks end in that order; held
    (N, top_k) bool). Picks of experts held elsewhere sort after every held
    one."""
    local = experts - first
    held = (local >= 0) & (local < n_held)
    local = torch.where(held, local, n_held).flatten()
    ordered, order = torch.sort(local, stable=True)
    bounds = torch.arange(1, n_held + 1, device=experts.device, dtype=ordered.dtype)
    ends = torch.searchsorted(ordered, bounds, right=False).to(torch.int32)
    return order, ends, held


def grouped_swiglu_plain(xs: torch.Tensor, ends: torch.Tensor, w_gate_up: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """The held experts' SwiGLU on the rows of each group, a loop over the
    experts: rows [ends[e - 1], ends[e]) through expert e (w_gate_up (E,
    2W, D) with the gate rows first, w_down (E, D, W)); rows past the last
    end come out zero."""
    out = xs.new_zeros((xs.shape[0], w_down.shape[1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            gate, up = linear(xs[start:end], w_gate_up[e]).chunk(2, dim=-1)
            out[start:end] = linear(F.silu(gate) * up, w_down[e])
        start = end
    return out


def grouped_swiglu(xs: torch.Tensor, ends: torch.Tensor, w_gate_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """grouped_swiglu_plain on the card: the gate/up product and the down
    product each one grouped launch over the held experts, the group ends
    read on the card. Rows past the last end hold no result."""
    if xs.device.type == "cpu":
        return grouped_swiglu_plain(xs, ends, w_gate_up, w_down)
    gate, up = torch._grouped_mm(xs, w_gate_up.transpose(-2, -1), offs=ends).chunk(2, dim=-1)
    return torch._grouped_mm(F.silu(gate) * up, w_down.transpose(-2, -1), offs=ends)


def swiglu_mlp(x: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """down(silu(gate(x)) * up(x)), the gate rows first in w_gate_up."""
    gate, up = linear(x, w_gate_up).chunk(2, dim=-1)
    return linear(F.silu(gate) * up, w_down)


class MoeCounters:
    """Counts one layer's passes keep on the card: `tokens` (n_held,) int64,
    the tokens routed to each held expert, and `stats` (3,) float64: the
    passes, the held experts with at least one token summed over passes,
    and the highest count over the mean count summed over passes (a pass
    that routes nothing here adds 1)."""

    def __init__(self, tokens: torch.Tensor, stats: torch.Tensor):
        self.tokens, self.stats = tokens, stats

    def add(self, ends: torch.Tensor) -> None:
        counts = torch.diff(ends.long(), prepend=ends.new_zeros(1).long())
        self.tokens += counts
        c = counts.double()
        mean = c.mean()
        peak = torch.where(mean > 0, c.max() / mean.clamp_min(1e-30), torch.ones_like(mean))
        self.stats += torch.stack([torch.ones_like(mean), (c > 0).double().sum(), peak])


def expert_layer(x: torch.Tensor, w_router: torch.Tensor, w_gate_up: torch.Tensor,
                 w_down: torch.Tensor, shared_gate_up: Optional[torch.Tensor],
                 shared_down: Optional[torch.Tensor], top_k: int, first: int,
                 counters: Optional[MoeCounters] = None) -> torch.Tensor:
    """x (N, D) -> sum over its held picks of p_e E_e(x), plus the shared
    expert (N, D), in x's dtype."""
    n, d = x.shape
    with tracing.span("moe.route"):
        weights, experts = route(x, w_router, top_k)
        order, ends, held = dispatch(experts, first, w_gate_up.shape[0])
        if counters is not None:
            counters.add(ends)
    with tracing.span("moe.experts"):
        ys = grouped_swiglu(x.index_select(0, order // top_k), ends, w_gate_up, w_down)
        y = torch.empty_like(ys).index_copy_(0, order, ys).view(n, top_k, d)
        y = torch.where(held[..., None], y.float() * weights[..., None], 0.0).sum(1)
    if shared_gate_up is not None:
        y = y + swiglu_mlp(x, shared_gate_up, shared_down).float()
    return y.to(x.dtype)
