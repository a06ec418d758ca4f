"""Expert parallelism: a GShard-style top-1 MoE MLP with its experts split
over an `expert` mesh axis.

PyTorch counterpart of coati_tpu/parallel/ep.py:

  * top-1 routing with a fixed capacity per expert, C = ceil(cf N / E);
    tokens past it are dropped (they contribute zero; the residual carries
    them), GShard (arXiv:2006.16668) section 3.2;
  * dispatch and combine as one-hot einsums, plain PyTorch products as
    coati_tpu's are plain XLA ones;
  * the GShard load-balance loss mean(fraction_tokens * fraction_gates) * E.

Over a (data, expert) mesh (`make_ep_mesh`) each rank holds E / n experts
(`shard_params_ep`; the router is replicated) and its data rank's tokens,
the same on every rank of an expert group.

Under coati_tpu's jit GSPMD routes the GLOBAL batch, so `moe_mlp` over a
data group does the same: N is the global token count, the capacity comes
from it, a token's place in its expert's queue counts the tokens of lower
data ranks first (an all-gather of the per-expert counts), and the
load-balance fractions are means over the global batch (sums over the data
group, differentiable through comm.all_reduce_sum).

Over the expert group each rank computes its experts' share of the output,
and the shares are summed with the Megatron pair of parallel/comm.py:
`copy_to_group` on the tokens and on the gates before the experts' products
(their gradients summed over the group, so that x's and the router's come
out whole on every rank) and `reduce_from_group` on the output.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as tF
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from coati_tpu_torch.common.util import resolve_device
from coati_tpu_torch.ops.layers import gelu_tanh
from coati_tpu_torch.parallel.comm import (
    all_reduce_,
    all_reduce_sum,
    copy_to_group,
    gather_rows,
    group_rank,
    group_size,
    reduce_from_group,
)
from coati_tpu_torch.parallel.mesh import axis_groups, make_axis_mesh
from coati_tpu_torch.parallel.placement import average_, fill_missing_grads, squared_norm


class MoeParams(nn.Module):
    """router (D, E), w_fc (E_local, D, F), b_fc (E_local, F), w_out
    (E_local, F, D), b_out (E_local, D): coati_tpu's fields and layout;
    E_local < E once shard_params_ep split the experts."""

    FIELDS = ("router", "w_fc", "b_fc", "w_out", "b_out")

    def __init__(self, router, w_fc, b_fc, w_out, b_out):
        super().__init__()
        for name, t in zip(self.FIELDS, (router, w_fc, b_fc, w_out, b_out)):
            setattr(self, name, nn.Parameter(t))


def init_moe(generator: torch.Generator, d: int, hidden: int, n_experts: int,
             device=None) -> MoeParams:
    """coati_tpu's init_moe with draws from `generator` (on `device`, the
    card unless the caller names another): uniform in +-1/sqrt(D) for the
    router and w_fc, +-1/sqrt(F) for w_out, zero biases."""
    device = resolve_device(device)

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return (2 * u - 1) * bound

    scale_in, scale_hid = 1.0 / math.sqrt(d), 1.0 / math.sqrt(hidden)
    return MoeParams(uniform((d, n_experts), scale_in),
                     uniform((n_experts, d, hidden), scale_in),
                     torch.zeros((n_experts, hidden), device=device),
                     uniform((n_experts, hidden, d), scale_hid),
                     torch.zeros((n_experts, d), device=device))


def moe_mlp(params: MoeParams, x: torch.Tensor, capacity_factor: float = 1.25,
            data_group=None, expert_group=None):
    """Top-1 MoE MLP. x: (B, T, D) -> (out (B, T, D), aux_loss). With a data
    group the routing is that of the concatenated batch of its ranks (which
    must hold equal token counts); with an expert group `params` holds this
    rank's experts, the rank-th E / n of them."""
    b, t, d = x.shape
    e = params.router.shape[1]
    n_data = group_size(data_group)
    n_tok = b * t
    n_global = n_tok * n_data
    cap = int(math.ceil(capacity_factor * n_global / e))
    xf = x.reshape(n_tok, d)

    gates = torch.softmax(xf.float() @ params.router, dim=-1)  # (N, E)
    idx = gates.argmax(dim=-1)
    gate = gates.gather(1, idx[:, None])[:, 0]
    onehot = tF.one_hot(idx, e)  # (N, E) int64
    counts = onehot.sum(dim=0)
    # a token's place in its expert's queue, in global token order
    offset = gather_rows(counts[None], data_group)[:group_rank(data_group)].sum(dim=0)
    pos = (onehot.cumsum(dim=0) - onehot + offset).gather(1, idx[:, None])[:, 0]

    e_local = params.w_fc.shape[0]
    e0 = group_rank(expert_group) * e_local
    mine = (idx >= e0) & (idx < e0 + e_local) & (pos < cap)
    disp = (tF.one_hot((idx - e0).clamp(0, e_local - 1), e_local).to(x.dtype)[:, :, None]
            * tF.one_hot(pos.clamp(0, cap - 1), cap).to(x.dtype)[:, None, :]
            * mine[:, None, None].to(x.dtype))  # (N, E_local, C)
    expert_in = torch.einsum("nec,nd->ecd", disp, copy_to_group(xf, expert_group))
    h = gelu_tanh(torch.einsum("ecd,edf->ecf", expert_in, params.w_fc) + params.b_fc[:, None, :])
    expert_out = torch.einsum("ecf,efd->ecd", h, params.w_out) + params.b_out[:, None, :]
    combine = disp * copy_to_group(gate, expert_group)[:, None, None].to(x.dtype)
    out = reduce_from_group(torch.einsum("nec,ecd->nd", combine, expert_out), expert_group)

    # load balance over the global batch (differentiable through the gates)
    frac_tokens = all_reduce_(counts.float(), data_group) / n_global
    frac_gates = all_reduce_sum(gates.sum(dim=0), data_group) / n_global
    aux = (frac_tokens * frac_gates).sum() * e
    return out.reshape(b, t, d), aux


def make_ep_mesh(n_devices: Optional[int] = None, expert: int = 2,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(data = n / expert) x (expert)."""
    return make_axis_mesh("expert", expert, n_devices, device_type)


def ep_param_specs(params: MoeParams):
    """{field: "expert" (split along its leading E axis) or None}: the
    experts are split, the router is replicated."""
    return {name: (None if name == "router" else "expert") for name in MoeParams.FIELDS}


def shard_params_ep(mesh: DeviceMesh, params: MoeParams) -> MoeParams:
    """This rank's experts (the expert rank's E / n) and the whole router."""
    _, _, _, n_shards, _, r = axis_groups(mesh, "expert")
    n_experts = params.w_fc.shape[0]
    if n_experts % n_shards:
        raise ValueError(f"n_experts {n_experts} must divide evenly into {n_shards} "
                         "expert shards")
    specs = ep_param_specs(params)
    with torch.no_grad():
        return MoeParams(*(getattr(params, k).detach().clone() if specs[k] is None
                           else getattr(params, k).detach().chunk(n_shards)[r].clone()
                           for k in MoeParams.FIELDS))


def gather_ep_params(mesh: DeviceMesh, params: MoeParams) -> MoeParams:
    """The whole MoeParams from every expert rank's share (a collective)."""
    _, expert_group, *_ = axis_groups(mesh, "expert")
    specs = ep_param_specs(params)
    with torch.no_grad():
        return MoeParams(*(getattr(params, k).detach().clone() if specs[k] is None
                           else gather_rows(getattr(params, k).detach(), expert_group)
                           for k in MoeParams.FIELDS))


def ep_grad_norm(mesh: DeviceMesh, params: MoeParams):
    """() -> the norm of the whole gradient: the experts' squares summed over
    the expert group, the router's counted once."""
    _, expert_group, *_ = axis_groups(mesh, "expert")

    def norm():
        sq = squared_norm([params.w_fc.grad, params.b_fc.grad, params.w_out.grad,
                           params.b_out.grad])
        all_reduce_(sq, expert_group)
        return (sq + squared_norm([params.router.grad])).sqrt()

    return norm


def make_ep_train_step(mesh: DeviceMesh, params: MoeParams, optimizer,
                       capacity_factor: float = 1.25, aux_weight: float = 0.01):
    """The MoE train step of coati_tpu's multi-chip dry run: loss =
    sum(out ** 2) + aux_weight * aux over the global batch. step(x) -> the
    loss (0-d tensor); x is this data rank's (B, T, D). Every rank takes the
    global loss (sums over data whose backward sums too), so its gradient is
    n_data times its share; the gradients are averaged over data, which
    gives the gradient of the global loss, and the optimizer steps this
    rank's experts and the router. With mesh None the step runs on one
    device."""
    data_group, expert_group, n_data, *_ = axis_groups(mesh, "expert")

    def step(x):
        out, aux = moe_mlp(params, x, capacity_factor, data_group, expert_group)
        loss = all_reduce_sum(out.float().square().sum(), data_group) + aux_weight * aux
        loss.backward()
        tensors = list(params.parameters())
        fill_missing_grads(tensors)
        average_([p.grad for p in tensors], data_group, n_data)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach()

    return step
