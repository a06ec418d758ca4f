"""The collectives of multi-device training, differentiable where a loss
flows through them.

One process per device (torch.distributed: NCCL on the card, gloo on the
CPU). Each function takes the process group of one mesh axis; a group of
one rank makes every collective the identity, so a world-1 run goes
through the same code.

  * `all_gather_rows`: the global contrastive batch. Forward gathers every
    rank's rows along dim 0; backward is a reduce-scatter that SUMS, the
    transpose of the gather (JAX's psum_scatter; the reference's
    differentiable all_gather, coati/models/autograd_funs/autograd_funs.py).
    Every rank computes the same global loss, so rank r's rows receive a
    gradient from every rank's copy; the sum, followed by the gradient
    average over the data axis, is the gradient of the global loss. Taking
    only the local slice would scale the contrastive gradient by 1/n.
  * `all_reduce_sum`: a global sum whose backward all-reduces too (psum's
    transpose): the numerator of the token-weighted AR loss.
  * The Megatron pair of tensor parallelism: `copy_to_group` (identity
    forward, all-reduce backward) before a column-parallel product, and
    `reduce_from_group` (all-reduce forward, identity backward) after a
    row-parallel one; `gather_last_dim` (all-gather forward, the local
    slice backward) for the vocab-parallel logits. Their backward rules
    hold because every rank of a model group computes the same thing
    downstream of them.
  * `broadcast_batch`: a host batch of tensors from one rank of a group to
    the others (the model axis reads one batch).
  * `ring_permute`: lax.ppermute with the perm i -> i + 1 mod S, the
    rotation of pipeline and sequence parallelism; its backward is the
    reverse rotation. Two routes (`permute_route`): point-to-point sends
    (batch_isend_irecv) where the backend takes the tensor, NCCL or gloo on
    a CPU tensor; an all-gather over the group, of which each rank keeps
    its predecessor's block, for gloo on a CUDA tensor (gloo's send and
    recv do not take one: on the card they end the process,
    scripts/torch_dist_probe.py; its all_gather_into_tensor carries it).
  * `pmin`: the minimum over a group, without autograd.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group (nothing for a group of one)."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x stacked along dim 0, rank order; no autograd."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out


def reduce_scatter_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group of x (n * R, ...), rank r keeping rows
    [r R, (r + 1) R); no autograd."""
    n = group_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_rows(grad, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.width = x.shape[-1]
        n = group_size(group)
        if n == 1:
            return x
        parts = gather_rows(x.movedim(-1, 0), group)  # (n * width, ...)
        return parts.movedim(0, -1)

    @staticmethod
    def backward(ctx, grad):
        start = group_rank(ctx.group) * ctx.width
        return grad.narrow(-1, start, ctx.width).contiguous(), None


def permute_route(x: torch.Tensor, group) -> str:
    """How ring_permute moves x over `group`: "p2p" or "all_gather"."""
    backend = dist.get_backend(group)
    return "all_gather" if backend == "gloo" and x.device.type != "cpu" else "p2p"


def _shift(x: torch.Tensor, group, step: int, route: Optional[str] = None) -> torch.Tensor:
    """Rank i's x delivered to rank i + step mod S (group ranks); no autograd."""
    n, r = group_size(group), group_rank(group)
    x = x.contiguous()
    if (route or permute_route(x, group)) == "all_gather":
        return gather_rows(x.unsqueeze(0), group)[(r - step) % n].clone()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + step) % n)
    src = dist.get_global_rank(group, (r - step) % n)
    ops = [dist.P2POp(dist.isend, x, dst, group), dist.P2POp(dist.irecv, out, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, route):
        ctx.group, ctx.route = group, route
        return _shift(x, group, 1, route)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1, ctx.route), None, None


def ring_permute(x: torch.Tensor, group, route: Optional[str] = None) -> torch.Tensor:
    """Rank i's x sent to rank i + 1 mod S of the group (lax.ppermute with
    that perm); backward sends each gradient back to rank i - 1. `route`
    forces "p2p" or "all_gather" (default: permute_route)."""
    if group_size(group) == 1:
        return x
    return _RingPermute.apply(x, group, route)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise minimum over the group (a copy); no autograd."""
    out = x.detach().clone()
    if group_size(group) > 1:
        dist.all_reduce(out, op=dist.ReduceOp.MIN, group=group)
    return out


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Rows of every rank along dim 0; backward reduce-scatters (sums)."""
    return _AllGatherRows.apply(x, group) if group_size(group) > 1 else x


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; backward all-reduces the gradient."""
    return _AllReduceSum.apply(x, group) if group_size(group) > 1 else x


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward sums the gradient over the group."""
    return _CopyToGroup.apply(x, group) if group_size(group) > 1 else x


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; backward passes the gradient through."""
    return _ReduceFromGroup.apply(x, group) if group_size(group) > 1 else x


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated along the last dim; backward keeps the
    local slice of the gradient."""
    return _GatherLastDim.apply(x, group) if group_size(group) > 1 else x


def broadcast_batch(batch: Optional[Dict[str, torch.Tensor]], dtypes: Dict[str, torch.dtype],
                    group, src: int, device) -> Dict[str, torch.Tensor]:
    """`batch` (the tensors named in `dtypes`, on the group's rank `src`, a
    global rank) sent to every rank of the group: first each tensor's shape
    (up to 4 dimensions), then the tensors. Other ranks pass None and
    receive tensors of `dtypes` on `device`."""
    keys = list(dtypes)
    header = torch.zeros((len(keys), 4), dtype=torch.long, device=device)
    if batch is not None:
        for i, k in enumerate(keys):
            shape = batch[k].shape
            header[i, : len(shape)] = torch.tensor(shape, dtype=torch.long)
    dist.broadcast(header, src, group=group)
    out = {}
    for i, k in enumerate(keys):
        if batch is not None:
            out[k] = batch[k].contiguous()
        else:
            shape = [int(s) for s in header[i].tolist() if s > 0]
            out[k] = torch.empty(shape, dtype=dtypes[k], device=device)
        dist.broadcast(out[k], src, group=group)
    return out
