"""Device meshes over one process per device.

PyTorch counterpart of coati_tpu/parallel/mesh.py. coati_tpu runs one
process per host with a mesh over all its devices; the port runs one
process per device, as PyTorch does (torch.distributed: NCCL on the card,
gloo on the CPU), and a mesh is a torch DeviceMesh over the ranks with
coati_tpu's axis names, ("data",) or ("data", "model").

  * `init_distributed` starts the default process group from the
    environment torch.distributed reads (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; torchrun sets them) unless one is running already.
  * `make_mesh` / `make_hybrid_mesh`: the mesh; the hybrid one puts each
    axis's host (DCN) factor outermost, as coati_tpu's does with
    create_hybrid_device_mesh, ranks being numbered host by host.
  * `rank_device`: the device of this rank, cuda:LOCAL_RANK on the card.
  * `replicate_params`: a broadcast from rank 0, so that every rank starts
    from the same weights.

`shard_batch` has no counterpart: every rank reads only its own rows
(training/train.py). `commit_to_template` became the restore of the
placements (parallel/placement.py `load_full_state`).
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from coati_tpu_torch.parallel.comm import group_rank, group_size


def default_device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def init_distributed(device_type: Optional[str] = None) -> None:
    """The default process group from the environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), NCCL for the card and gloo for the CPU;
    nothing if a group is running. On the card the rank's device is made
    current first (rank_device), as NCCL and DeviceMesh expect."""
    if not dist.is_initialized():
        device_type = device_type or default_device_type()
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if (device_type or backend_device_type()) == "cuda":
        torch.cuda.set_device(rank_device())


def backend_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else default_device_type()


def make_mesh(n_devices: Optional[int] = None, axis_names: Sequence[str] = ("data",),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh over every rank: all of them on the first axis, 1 on the
    others. n_devices, when given, must be the world size."""
    init_distributed(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the world has {world} ranks (one a device)")
    shape = (world,) + (1,) * (len(axis_names) - 1)
    return DeviceMesh(device_type or backend_device_type(),
                      torch.arange(world).reshape(shape), mesh_dim_names=tuple(axis_names))


def make_axis_mesh(axis: str, size: int, n_devices: Optional[int] = None,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """(data = world / size) x (`axis` = size) over every rank, the named
    axis inner, so that its groups hold neighbouring ranks: the meshes of
    pipeline ("pipe"), sequence ("seq") and expert ("expert") parallelism.
    n_devices, when given, must be the world size."""
    init_distributed(device_type)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the world has {world} ranks (one a device)")
    if world % size:
        raise ValueError(f"{world} ranks do not split into {axis} groups of {size}")
    return DeviceMesh(device_type or backend_device_type(),
                      torch.arange(world).reshape(world // size, size),
                      mesh_dim_names=("data", axis))


def axis_groups(mesh: DeviceMesh, axis: str):
    """(data group, `axis` group, data size, axis size, data rank, axis
    rank) of a two-axis mesh; a group of one rank is None, and so is every
    group of no mesh (one device)."""
    if mesh is None:
        return None, None, 1, 1, 0, 0
    out = []
    for name in ("data", axis):
        group = mesh.get_group(name)
        out.append(group if group_size(group) > 1 else None)
    data, inner = out
    return (data, inner, group_size(data), group_size(inner), group_rank(data),
            group_rank(inner))


def make_hybrid_mesh(axis_names: Sequence[str], ici_shape: Sequence[int],
                     dcn_shape: Sequence[int], device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh whose axis i has ici_shape[i] * dcn_shape[i] ranks, the host
    (DCN) factor outermost: ranks are numbered host by host, prod(ici_shape)
    a host, so the fast axes stay inside a host. Put data-parallel factors
    in dcn_shape and model factors in ici_shape."""
    if not len(axis_names) == len(ici_shape) == len(dcn_shape):
        raise ValueError(f"axis_names {axis_names}, ici_shape {ici_shape} and dcn_shape "
                         f"{dcn_shape} differ in length")
    init_distributed(device_type)
    k = len(axis_names)
    world = dist.get_world_size()
    n_ici, n_dcn = 1, 1
    for i, d in zip(ici_shape, dcn_shape):
        n_ici, n_dcn = n_ici * i, n_dcn * d
    if n_ici * n_dcn != world:
        raise ValueError(f"the mesh holds {n_ici * n_dcn} ranks, the world {world}")
    ranks = torch.arange(world).reshape(*dcn_shape, *ici_shape)
    order = [j for i in range(k) for j in (i, k + i)]  # (dcn_0, ici_0, dcn_1, ici_1, ...)
    total = [i * d for i, d in zip(ici_shape, dcn_shape)]
    return DeviceMesh(device_type or backend_device_type(),
                      ranks.permute(order).reshape(total), mesh_dim_names=tuple(axis_names))


def rank_device(mesh: Optional[DeviceMesh] = None) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK (rank modulo the cards when
    LOCAL_RANK is unset) for a CUDA mesh (or, without a mesh, an NCCL
    group), else the CPU."""
    device_type = mesh.device_type if mesh is not None else backend_device_type()
    if device_type != "cuda":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    return torch.device("cuda", local)


def on_device(device: torch.device):
    """A context that makes `device` current when it is a card."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


@dataclass
class MeshAxes:
    """The groups, sizes and ranks of a mesh's two axes; a mesh without a
    `model` axis has a model axis of one rank (group None)."""

    data_group: object
    model_group: object
    n_data: int
    n_model: int
    data_rank: int
    model_rank: int

    @classmethod
    def of(cls, mesh: DeviceMesh) -> "MeshAxes":
        names = mesh.mesh_dim_names or ()
        if "data" not in names:
            raise ValueError(f"a mesh needs a 'data' axis, got {names}")
        data = mesh.get_group("data")
        model = mesh.get_group("model") if "model" in names and mesh.size(
            names.index("model")) > 1 else None
        return cls(data, model, group_size(data), group_size(model),
                   group_rank(data), group_rank(model))

    @property
    def model_source(self) -> int:
        """The global rank of this rank's model group's first rank."""
        if self.model_group is None:
            return dist.get_rank()
        return dist.get_global_rank(self.model_group, 0)


@torch.no_grad()
def replicate_params(mesh: Optional[DeviceMesh], model: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer broadcast from rank 0 (in place)."""
    if mesh is None or dist.get_world_size() == 1:
        return model
    for t in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(t.data, 0)
    return model
