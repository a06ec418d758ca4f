"""Parameter placement shared by the trainers.

PyTorch counterpart of coati_tpu/parallel/placement.py, with its rules and
errors: `resolve_placement(mesh, param_sharding, parallel_mode)` maps the
TrainConfig fields to a placement:

  * "auto": replication (data parallelism) on a mesh without a model axis
    above 1, Megatron tensor parallelism on one with it (parallel/tp.py),
    which needs parallel_mode "pjit";
  * "replicated": replication, even on a mesh with a model axis;
  * "fsdp": parameters and AdamW's moments sharded over the data axis
    (parallel/fsdp.py), which needs parallel_mode "pjit";
  * anything else raises ValueError.

A placement is built over the model and the config
(`placement(mesh, model, config)`) and owns the optimizer. The trainer
calls `before_forward` (FSDP gathers the parameters), runs the forward and
the backward, then `step` (the gradients reduced over the data axis, the
global-norm clip and AdamW). `full_state` gathers the model's state dict
and the optimizer's, in the layout a single-device run has, on every rank
(a collective); `load_full_state` places such a state, so a restart saved
at one world size resumes at another.

This module holds the replicated placement, which the two others extend.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from coati_tpu_torch.parallel.comm import all_reduce_
from coati_tpu_torch.parallel.mesh import MeshAxes, replicate_params


def squared_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """Sum of the squares of the tensors, in float32."""
    if not grads:
        return torch.zeros(())
    return torch.stack(torch._foreach_norm([g.float() for g in grads])).square().sum()


def average_(tensors: List[torch.Tensor], group, n: int) -> None:
    """Each tensor replaced by its mean over the group, through one flat
    all-reduce."""
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    flat /= n
    torch._foreach_copy_(tensors, [c.view_as(t) for c, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


def fill_missing_grads(params) -> None:
    """A parameter no loss reaches gets a zero gradient, so that it decays
    and takes part in the reductions as under optax."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class ReplicatedPlacement:
    """Data parallelism: every rank holds the whole model and optimizer;
    the gradients are averaged over the data axis."""

    def __init__(self, mesh: DeviceMesh, model: torch.nn.Module, config):
        self.mesh = mesh
        self.axes = MeshAxes.of(mesh)
        self.model = model
        self.config = config
        self.names = [n for n, _ in model.named_parameters()]
        self._place()
        self.optimizer = self._make_optimizer()

    # -- layout
    def _place(self) -> None:
        replicate_params(self.mesh, self.model)

    def _make_optimizer(self):
        from coati_tpu_torch.training.train import make_optimizer

        return make_optimizer(self.config, self.model)

    # -- the step
    def before_forward(self) -> None:
        """Nothing to gather."""

    def reduce_gradients(self) -> None:
        params = list(self.model.parameters())
        fill_missing_grads(params)
        average_([p.grad for p in params], self.axes.data_group, self.axes.n_data)

    def step(self) -> None:
        """Reduce the gradients, clip by the global norm, AdamW, drop the
        gradients."""
        self.reduce_gradients()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    # -- the full state
    def full_state(self) -> Tuple[Dict[str, torch.Tensor], dict]:
        return self.model.state_dict(), self.optimizer.state_dict()

    def load_full_state(self, model_state: Dict[str, torch.Tensor], opt_state: dict) -> None:
        self.model.load_state_dict(model_state, strict=True)
        self.optimizer.load_state_dict(opt_state)

    def gathered_model(self) -> torch.nn.Module:
        """The model with whole parameters (a collective)."""
        return self.model


def resolve_placement(mesh: Optional[DeviceMesh], param_sharding: str, parallel_mode: str):
    """-> the placement class for (param_sharding, parallel_mode) on `mesh`;
    ValueError for a combination coati_tpu refuses."""
    if parallel_mode not in ("pjit", "shard_map"):
        raise ValueError(f"unknown parallel_mode {parallel_mode!r}")
    if param_sharding == "fsdp":
        if parallel_mode != "pjit":
            raise ValueError("fsdp requires parallel_mode='pjit'")
        from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement

        return FullyShardedPlacement
    if param_sharding == "replicated":
        return ReplicatedPlacement
    if param_sharding != "auto":
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if "model" in names and mesh.size(names.index("model")) > 1:
        if parallel_mode != "pjit":
            raise ValueError("tensor parallelism requires parallel_mode='pjit'")
        from coati_tpu_torch.parallel.tp import TensorParallelPlacement

        return TensorParallelPlacement
    return ReplicatedPlacement
