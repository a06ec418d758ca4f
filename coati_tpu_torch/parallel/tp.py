"""Tensor parallelism (Megatron layout) over the mesh's `model` axis.

PyTorch counterpart of coati_tpu/parallel/tp.py. coati_tpu hands GSPMD
PartitionSpecs and lets it insert the collectives; the port writes them
out (parallel/comm.py) in the transformer's forward
(models/transformer.py reads the `tp` group that this placement sets on
every SmilesTransformer). The rules are coati_tpu's `_TP_RULES`, leaf for
leaf under the reference's names (weights are (out, in) here):

  attn.c_attn  (3D, D)  column-parallel, q, k and v each split BY HEADS
  mlpf.0       (4D, D)  column-parallel (bias with it)
  attn.c_proj  (D, D)   row-parallel; its bias replicated, added once
                        after the all-reduce
  mlpf.2       (D, 4D)  row-parallel; bias likewise
  emb.tok_emb  (V, D)   vocab-parallel: out-of-range tokens masked, the
                        rows all-reduced
  lm_head      (V, D)   vocab-parallel: the logits gathered (differentiably)
                        before the unchanged cross-entropy

A leaf whose dimension does not divide by the model axis (the 'mar' vocab
of 13,603) is replicated, as are the LayerNorms, the EGNN and every other
leaf. GSPMD splits c_attn's 3D outputs contiguously, so at tp 2 one rank
would hold all of q and half of k; an explicit program cannot run
attention on that, so the port splits each of q, k and v by heads and
each rank runs the attention kernel on its own H / tp heads (n_head must
divide by the model axis). Saving gathers back to the reference layout
(models/convert.py merge_states).
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from coati_tpu_torch.models.convert import merge_tensors, split_tensor
from coati_tpu_torch.models.transformer import SmilesTransformer
from coati_tpu_torch.parallel.comm import all_reduce_, gather_rows
from coati_tpu_torch.parallel.mesh import backend_device_type, init_distributed, replicate_params
from coati_tpu_torch.parallel.placement import ReplicatedPlacement, squared_norm


@dataclass(frozen=True)
class ShardSpec:
    """A sharded leaf: the dimension split over the model axis, and whether
    it is the fused q | k | v projection (split within each third)."""

    dim: int
    qkv: bool = False


# key inside a SmilesTransformer -> spec (coati_tpu's _TP_RULES)
_TP_RULES = (
    (re.compile(r"transformer\.h\.\d+\.attn\.c_attn\.(weight|bias)$"), ShardSpec(0, qkv=True)),
    (re.compile(r"transformer\.h\.\d+\.mlpf\.0\.(weight|bias)$"), ShardSpec(0)),
    (re.compile(r"transformer\.h\.\d+\.attn\.c_proj\.weight$"), ShardSpec(1)),
    (re.compile(r"transformer\.h\.\d+\.mlpf\.2\.weight$"), ShardSpec(1)),
    (re.compile(r"emb\.tok_emb(\.0)?\.weight$"), ShardSpec(0)),
    (re.compile(r"lm_head\.weight$"), ShardSpec(0)),
)


def make_tp_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(data = n / model_parallel) x (model = model_parallel); the model
    axis is the inner one, so a model group's ranks are neighbours."""
    init_distributed(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the world has {world} ranks (one a device)")
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into model groups of {model_parallel}")
    return DeviceMesh(device_type or backend_device_type(),
                      torch.arange(world).reshape(world // model_parallel, model_parallel),
                      mesh_dim_names=("data", "model"))


def _rule(key: str) -> Optional[ShardSpec]:
    for pattern, spec in _TP_RULES:
        if pattern.search(key):
            return spec
    return None


def param_specs(model: torch.nn.Module, tp_size: int, n_head: Optional[int] = None
                ) -> Dict[str, Optional[ShardSpec]]:
    """{parameter name: ShardSpec or None (replicated)} for a CoatiModel,
    Coati2Model or bare SmilesTransformer. Raises when the attention would
    shard but n_head does not divide by tp_size."""
    specs: Dict[str, Optional[ShardSpec]] = {name: None for name, _ in model.named_parameters()}
    for prefix, mod in model.named_modules():
        if not isinstance(mod, SmilesTransformer):
            continue
        for key, p in mod.named_parameters():
            spec = _rule(key)
            if spec is None:
                continue
            size = p.shape[spec.dim] // (3 if spec.qkv else 1)
            if size % tp_size:
                continue
            if spec.qkv and n_head is not None and n_head % tp_size:
                raise ValueError(f"n_head {n_head} does not divide by the model axis {tp_size}: "
                                 "the port shards attention by whole heads")
            specs[f"{prefix}.{key}" if prefix else key] = spec
    return specs


class TensorParallelPlacement(ReplicatedPlacement):
    """Each rank holds its model group's shards of the transformer and the
    whole of every other leaf; the gradients are averaged over the data
    axis, and the global-norm clip counts a sharded leaf's squares across
    the model axis and a replicated leaf's once."""

    def _place(self) -> None:
        replicate_params(self.mesh, self.model)
        n, r = self.axes.n_model, self.axes.model_rank
        self.specs = param_specs(self.model, n, getattr(self.config, "n_head", None))
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                spec = self.specs[name]
                if spec is not None:
                    p.data = split_tensor(p.data, spec.dim, r, n, spec.qkv)
        for mod in self.model.modules():
            if isinstance(mod, SmilesTransformer):
                mod.tp = self.axes.model_group

    def _make_optimizer(self):
        from coati_tpu_torch.training.train import make_optimizer

        return make_optimizer(self.config, self.model, grad_norm=self._grad_norm)

    def _grad_norm(self) -> torch.Tensor:
        sharded, replicated = [], []
        for name, p in self.model.named_parameters():
            (sharded if self.specs[name] is not None else replicated).append(p.grad)
        sq = squared_norm(sharded)
        all_reduce_(sq, self.axes.model_group)
        return (sq + squared_norm(replicated)).sqrt()

    def _gather(self, t: torch.Tensor, spec: Optional[ShardSpec]) -> torch.Tensor:
        if spec is None:
            return t
        parts = gather_rows(t.unsqueeze(0).contiguous(), self.axes.model_group)
        return merge_tensors(list(parts), spec.dim, spec.qkv)

    def full_state(self):
        names = self.names
        model_state = {k: self._gather(v, self.specs.get(k))
                       for k, v in self.model.state_dict().items()}
        opt = self.optimizer.state_dict()
        state = {}
        for idx, s in opt["state"].items():
            spec = self.specs[names[idx]]
            state[idx] = {k: self._gather(v, spec) if k != "step" else v for k, v in s.items()}
        return model_state, {"state": state, "param_groups": opt["param_groups"]}

    def load_full_state(self, model_state, opt_state) -> None:
        n, r = self.axes.n_model, self.axes.model_rank

        def shard(t, spec):
            return t if spec is None else split_tensor(t, spec.dim, r, n, spec.qkv)

        self.model.load_state_dict({k: shard(v, self.specs.get(k))
                                    for k, v in model_state.items()}, strict=True)
        state = {idx: {k: shard(v, self.specs[self.names[idx]]) if k != "step" else v
                       for k, v in s.items()}
                 for idx, s in opt_state["state"].items()}
        self.optimizer.load_state_dict({"state": state,
                                        "param_groups": opt_state["param_groups"]})

    def gathered_model(self) -> torch.nn.Module:
        """A copy of the model with whole parameters and no `tp` group."""
        full = self.full_state()[0]
        trunks = [m for m in self.model.modules() if isinstance(m, SmilesTransformer)]
        for m in trunks:
            del m.tp
        try:
            model = copy.deepcopy(self.model)
        finally:
            for m in trunks:
                m.tp = self.axes.model_group
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.data = full[name].clone()
        return model

