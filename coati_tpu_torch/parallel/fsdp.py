"""Fully-sharded data parallelism (ZeRO-3 style) over the mesh's data axis.

PyTorch counterpart of coati_tpu/parallel/fsdp.py. Each rank keeps its
shard of the float32 master weights and of AdamW's two moments; the step
all-gathers the full parameters into the model before the forward and
reduce-scatters (averages) the gradients onto the shards after the
backward. The global-norm clip all-reduces the sum of squares over the
shards, so every rank clips by the norm of the whole gradient.

Layout rule, coati_tpu's `_leaf_spec`: a leaf shards its LARGEST dimension
divisible by the data axis, ties going to the trailing one in coati_tpu's
(in, out) layout, i.e. to the output dimension of a linear weight; a leaf
with no divisible dimension is replicated. coati_tpu stacks the layers of
a tower along a leading axis that the rule could pick; here every layer is
its own tensor and the rule runs on that tensor (the layer axis, 16 at
most, is never the largest at the widths the model takes).

The shards of every sharded leaf live in one flat float32 buffer per rank
(`flat`, the optimizer's parameter): leaf by leaf, the rank's piece of the
leaf with its sharded dimension moved to the front, so that one
all_gather_into_tensor and one reduce_scatter_tensor carry the whole
model. Replicated leaves keep their own parameters, whose gradients are
all-reduced.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from coati_tpu_torch.parallel.comm import all_reduce_, gather_rows, reduce_scatter_rows
from coati_tpu_torch.parallel.mesh import replicate_params
from coati_tpu_torch.parallel.placement import (
    ReplicatedPlacement,
    average_,
    fill_missing_grads,
    squared_norm,
)


def _leaf_dim(shape: Sequence[int], n_shards: int) -> Optional[int]:
    """coati_tpu's _leaf_spec on one shape: the largest dimension divisible
    by n_shards, the trailing one of equals; None when none divides."""
    best = None  # (size, dim)
    for dim, size in enumerate(shape):
        if size >= n_shards and size % n_shards == 0:
            if best is None or size >= best[0]:
                best = (size, dim)
    return None if best is None else best[1]


def fsdp_specs(model: nn.Module, n_shards: int) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension sharded over the data axis, or None}.
    A linear weight is (out, in) here and (in, out) in coati_tpu, so the rule
    reads its shape reversed."""
    linear = {id(m.weight) for m in model.modules() if isinstance(m, nn.Linear)}
    specs = {}
    for name, p in model.named_parameters():
        if id(p) in linear and p.ndim == 2:
            dim = _leaf_dim(tuple(reversed(p.shape)), n_shards)
            specs[name] = None if dim is None else 1 - dim
        else:
            specs[name] = _leaf_dim(tuple(p.shape), n_shards)
    return specs


def _moved_shape(shape, dim: int):
    return (shape[dim],) + tuple(s for i, s in enumerate(shape) if i != dim)


class FullyShardedPlacement(ReplicatedPlacement):
    """The model holds the full parameters as a working copy, rewritten by
    every gather; the optimizer steps `flat` (this rank's shards) and the
    replicated leaves."""

    def _place(self) -> None:
        replicate_params(self.mesh, self.model)
        n, r = self.axes.n_data, self.axes.data_rank
        self.params = dict(self.model.named_parameters())
        specs = fsdp_specs(self.model, n)
        self.sharded = [(name, dim) for name, dim in specs.items() if dim is not None]
        self.replicated = [name for name, dim in specs.items() if dim is None]
        self.chunk = [self.params[name].numel() // n for name, _ in self.sharded]
        with torch.no_grad():
            self.flat = nn.Parameter(torch.cat(
                [self._rows(self.params[name].detach(), dim)[r] for name, dim in self.sharded]
                or [torch.zeros(0)]).float())

    def _rows(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """(n, numel / n): row r is rank r's piece of t, flattened."""
        return t.movedim(dim, 0).reshape(self.axes.n_data, -1)

    def _unflatten(self, full: torch.Tensor):
        """(n * S,) gathered shards -> {name: full tensor}."""
        view = full.view(self.axes.n_data, -1)
        out, off = {}, 0
        for (name, dim), c in zip(self.sharded, self.chunk):
            shape = self.params[name].shape
            out[name] = view[:, off:off + c].reshape(_moved_shape(shape, dim)).movedim(0, dim)
            off += c
        return out

    def _make_optimizer(self):
        from coati_tpu_torch.training.train import make_optimizer

        return make_optimizer(self.config, [self.flat] + [self.params[n] for n in self.replicated],
                              grad_norm=self._grad_norm)

    def before_forward(self) -> None:
        """All-gather the shards into the model's parameters."""
        full = self._unflatten(gather_rows(self.flat.detach(), self.axes.data_group))
        with torch.no_grad():
            names = [name for name, _ in self.sharded]
            torch._foreach_copy_([self.params[k] for k in names], [full[k] for k in names])

    def reduce_gradients(self) -> None:
        fill_missing_grads(self.params.values())
        n = self.axes.n_data
        rows = torch.cat([self._rows(self.params[name].grad, dim) for name, dim in self.sharded],
                         dim=1)
        local = reduce_scatter_rows(rows.reshape(-1), self.axes.data_group)
        self.flat.grad = local / n
        for name, _ in self.sharded:
            self.params[name].grad = None
        average_([self.params[k].grad for k in self.replicated], self.axes.data_group, n)

    def gathered_model(self) -> nn.Module:
        self.before_forward()
        return self.model

    def _grad_norm(self) -> torch.Tensor:
        sq = squared_norm([self.flat.grad])
        all_reduce_(sq, self.axes.data_group)
        return (sq + squared_norm([self.params[k].grad for k in self.replicated])).sqrt()

    # -- the full state, in the single-device layout
    def full_state(self):
        self.before_forward()
        model_state = self.model.state_dict()
        order = {name: i for i, name in enumerate(self.names)}
        state = {}
        flat_state = self.optimizer.state.get(self.flat)
        if flat_state:
            moments = {k: self._unflatten(gather_rows(v, self.axes.data_group))
                       for k, v in flat_state.items() if k != "step"}
            for name, _ in self.sharded:
                state[order[name]] = dict(step=flat_state["step"],
                                          **{k: m[name] for k, m in moments.items()})
        for name in self.replicated:
            s = self.optimizer.state.get(self.params[name])
            if s:
                state[order[name]] = dict(s)
        group = {k: v for k, v in self.optimizer.param_groups[0].items() if k != "params"}
        return model_state, {"state": dict(sorted(state.items())),
                             "param_groups": [dict(group, params=list(range(len(self.names))))]}

    def load_full_state(self, model_state, opt_state) -> None:
        self.model.load_state_dict(model_state, strict=True)
        r = self.axes.data_rank
        order = {name: i for i, name in enumerate(self.names)}

        def local(tensors):
            return torch.cat([self._rows(tensors[name].to(self.flat.device), dim)[r]
                              for name, dim in self.sharded])

        with torch.no_grad():
            self.flat.copy_(local(self.params))
        saved = opt_state["state"]
        state = {}
        if self.sharded and order[self.sharded[0][0]] in saved:
            first = saved[order[self.sharded[0][0]]]
            state[0] = {"step": first["step"]}
            for k in first:
                if k != "step":
                    state[0][k] = local({name: saved[order[name]][k] for name, _ in self.sharded})
        for i, name in enumerate(self.replicated, start=1):
            if order[name] in saved:
                state[i] = saved[order[name]]
        group = {k: v for k, v in opt_state["param_groups"][0].items() if k != "params"}
        self.optimizer.load_state_dict({
            "state": state,
            "param_groups": [dict(group, params=list(range(1 + len(self.replicated))))]})
