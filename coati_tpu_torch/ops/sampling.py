"""Token sampling: top-k + inverse-temperature categorical, optional top-p.

The exact path of coati_tpu/ops/sampling.py::sample_top_k: the draw
happens in the (..., k) CANDIDATE space and the winner maps back through
the candidate indices. Exactly k candidates are kept, a tie at the k-th
value going to the lower token index, as lax.top_k and the reference's
torch.topk + multinomial do. The TPU's approximate top-k
(lax.approx_max_k) has no counterpart here: the port is always exact.

The random numbers come from a torch.Generator on the logits' device, so
they differ from JAX's; draws agree with the JAX package in distribution,
and token for token only at k = 1.
"""

from __future__ import annotations

from typing import Optional

import torch

from coati_tpu_torch.ops.kernels.top_k import top_k


def top_k_candidates(logits: torch.Tensor, k: int):
    """(values, indices), each (..., k): the k largest logits, sorted
    descending, ties ordered by lower index first, as a stable sort gives
    them (torch.topk leaves the order of ties unspecified). On the card K7
    finds them without sorting the row (ops/kernels/top_k.py); CPU tensors
    take the stable sort."""
    return top_k(logits, k)


def top_k_filter(logits: torch.Tensor, k: int, approx: bool = False) -> torch.Tensor:
    """Logits below each row's k-th largest value set to -inf. The mask is
    by value, as coati_tpu's: a logit tied with the k-th value survives
    whatever its index. `approx` has no approximate form on the card (the
    TPU's lax.approx_max_k); the threshold is always exact."""
    del approx
    kth = top_k_candidates(logits, k)[0][..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(
    logits: torch.Tensor, top_p: float, k: int, approx: bool = False
) -> torch.Tensor:
    """Nucleus filter over logits already masked to their top k: logits
    outside the smallest set of the k candidates whose probability reaches
    `top_p` set to -inf (the most probable always survives). The mass is
    taken over the k candidate values, which equals the softmax of the
    whole masked row. `approx` is ignored: the candidates are exact."""
    del approx
    vals = top_k_candidates(logits, k)[0]
    probs = torch.softmax(vals, dim=-1)
    # a candidate stays when the mass before it is still < top_p
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    thresh = vals.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def sample_top_k(
    generator: Optional[torch.Generator],
    logits: torch.Tensor,
    k: int,
    inv_temp: float,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Draw token ids (...,) from the top-k filtered distribution, with
    optional nucleus (top-p) truncation within the k candidates after
    temperature. k = 1 is greedy: the first index of the row maximum."""
    lf = logits.float()
    if k == 1:  # one candidate: the draw is certain, and argmax keeps the lower index on ties
        return lf.argmax(dim=-1)
    vals, idxs = top_k_candidates(lf, min(k, lf.shape[-1]))
    scaled = vals * inv_temp  # sorted descending
    if top_p is not None and top_p < 1.0:
        probs = torch.softmax(scaled, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # a candidate stays when the mass BEFORE it is still < top_p;
        # the argmax always survives (its "before" mass is 0)
        keep = (cum - probs) < top_p
        scaled = scaled.masked_fill(~keep, float("-inf"))
    # Gumbel-max draw of a categorical over the candidates
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u))
    choice = torch.argmax(scaled + gumbel, dim=-1, keepdim=True)
    return torch.gather(idxs, -1, choice)[..., 0]
