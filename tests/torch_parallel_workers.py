"""The rank side of tests/test_torch_parallel.py, free of JAX: it runs in
processes started by torch.multiprocessing.spawn, one a rank, over gloo on
the CPU (init_method file://, one torch thread a rank).

The test process writes, under one directory: `setup.json` (the model
sizes, the learning rate, the clip), `weights.npz` / `weights2.npz` (the
port's state dicts of one COATI and one COATI2, numpy, keyed by the
reference's names) and `batches.npz` (the global batches of each step and
the clip-token choices). Each rank runs the scenarios named for its world
on its rows of every global batch; rank 0 writes `results<world>.pt`."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from coati_tpu_torch.data.batch_pipe import batch_rows
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import coati2 as t2
from coati_tpu_torch.parallel.comm import all_gather_rows
from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement, fsdp_specs
from coati_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh
from coati_tpu_torch.parallel.placement import ReplicatedPlacement, resolve_placement
from coati_tpu_torch.parallel.tp import TensorParallelPlacement, make_tp_mesh
from coati_tpu_torch.training import config as tconfig
from coati_tpu_torch.training import train as ttrain
from coati_tpu_torch.training import train_coati2 as tt2

JOIN_SECONDS = 240


# ------------------------------------------------------------- the inputs


def load_setup(root: Path):
    setup = json.loads((root / "setup.json").read_text())
    batches = dict(np.load(root / "batches.npz"))
    return setup, batches


def coati_model(root: Path, setup) -> tuple:
    cfg = tco.CoatiConfig(**setup["coati"])
    model = tco.CoatiModel(cfg)
    state = {k: torch.tensor(v) for k, v in np.load(root / "weights.npz").items()}
    model.load_state_dict(state, strict=True)
    return model, cfg


def coati2_model(root: Path, setup) -> tuple:
    cfg = t2.Coati2Config(**setup["coati2"])
    model = t2.Coati2Model(cfg)
    state = {k: torch.tensor(v) for k, v in np.load(root / "weights2.npz").items()}
    model.load_state_dict(state, strict=True)
    return model, cfg


def rows_of(batches, prefix: str, step: int, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of global batch `step` (keys '<prefix><step>/<field>')."""
    key = f"{prefix}{step}/"
    out = {}
    for name, v in batches.items():
        if name.startswith(key):
            field = name[len(key):]
            dtype = torch.float32 if v.dtype.kind == "f" else torch.long
            out[field] = torch.tensor(v[lo:hi], dtype=dtype)
    return out


def coati_step(model, cfg, setup, placement, mode):
    return ttrain.TrainStep(model, cfg, placement.optimizer,
                            parallel=ttrain.ParallelStep(placement, mode), **setup["step"])


def train_config(setup, **kw):
    return tconfig.TrainConfig(lr=setup["lr"], clip_grad=setup["clip_grad"],
                               n_head=setup["coati"]["n_head"], **kw)


# --------------------------------------------------------------- scenarios


def _run_coati(root, setup, batches, mesh, placement_cls, mode, prefix="batch",
               pick_prefix=None):
    """Steps of a COATI over `mesh` from the saved weights, each data rank on
    its rows: (losses per step, the gathered state, the clip's norms)."""
    model, cfg = coati_model(root, setup)
    placement = placement_cls(mesh, model, train_config(setup, parallel_mode=mode))
    step = coati_step(model, cfg, setup, placement, mode)
    n, r = placement.axes.n_data, placement.axes.data_rank
    losses, norms = [], []
    for i in range(setup["steps"]):
        rows = batches[f"{prefix}{i}/tokens"].shape[0]
        lo, hi = r * rows // n, (r + 1) * rows // n
        batch = rows_of(batches, prefix, i, lo, hi)
        pick = batch.pop(pick_prefix or "pick")
        metrics = step(None, batch, pick_point=pick)
        losses.append([float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")])
        norms.append(float(step.optimizer.last_grad_norm))
    return losses, placement.full_state(), norms, placement


def scenario_dp(root, setup, batches):
    """Data parallelism at world 2, both formulations, and both formulations
    on a batch whose two halves carry equal token counts."""
    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    out = {}
    for mode, pick in (("pjit", "pick"), ("shard_map", "pick_shard")):
        losses, (state, _), _, _ = _run_coati(root, setup, batches, mesh, ReplicatedPlacement,
                                              mode, pick_prefix=pick)
        out[mode] = {"losses": losses, "state": state}
    for mode in ("pjit", "shard_map"):
        losses, (state, _), _, _ = _run_coati(root, setup, batches, mesh, ReplicatedPlacement,
                                              mode, prefix="even")
        out[f"even_{mode}"] = {"losses": losses, "state": state}
    return out


def scenario_clip_gradient(root, setup, batches):
    """The CLIP term's gradient at world 2 (all_gather_rows, then the mean of
    the gradients) against the single-device gradient on the concatenated
    batch; and all_gather_rows alone: its backward sums every rank's
    gradient of this rank's rows."""
    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    model, cfg = coati_model(root, setup)
    placement = ReplicatedPlacement(mesh, model, train_config(setup))
    step = coati_step(model, cfg, setup, placement, "pjit")
    r = placement.axes.data_rank
    rows = batches["batch0/tokens"].shape[0]
    batch = rows_of(batches, "batch", 0, r * rows // 2, (r + 1) * rows // 2)
    pick = batch.pop("pick")
    _, _, cl = step.losses(None, batch, pick_point=pick)
    cl.backward()
    placement.reduce_gradients()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    single = {}
    if r == 0:
        ref_model, _ = coati_model(root, setup)
        ref = ttrain.TrainStep(ref_model, cfg, None, **setup["step"])
        whole = rows_of(batches, "batch", 0, 0, rows)
        _, _, ref_cl = ref.losses(None, whole, pick_point=whole.pop("pick"))
        ref_cl.backward()
        single = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                  for n, p in ref_model.named_parameters()}
    # all_gather_rows alone
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * r
    x.requires_grad_(True)
    weights = torch.arange(12, dtype=torch.float32).reshape(6, 2)  # the same on every rank
    (all_gather_rows(x, placement.axes.data_group) * weights).sum().backward()
    return {"grads": grads, "single": single, "gather_grad": x.grad.clone(),
            "gather_want": 2 * weights[3 * r:3 * r + 3]}


def scenario_fsdp(root, setup, batches):
    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    losses, (state, opt_state), norms, placement = _run_coati(
        root, setup, batches, mesh, FullyShardedPlacement, "pjit")
    sizes = {n: p.numel() for n, p in placement.model.named_parameters()}
    moments = [int(s["exp_avg"].numel()) for s in placement.optimizer.state.values()]
    gathered = dist.get_world_size()
    counts = [None] * gathered
    dist.all_gather_object(counts, sum(moments))
    specs = fsdp_specs(placement.model, 2)
    single = None
    if dist.get_rank() == 0:  # the clip's norm of the first step on one device
        ref_model, cfg = coati_model(root, setup)
        ref = ttrain.TrainStep(ref_model, cfg, ttrain.make_optimizer(train_config(setup),
                                                                      ref_model), **setup["step"])
        whole = rows_of(batches, "batch", 0, 0, batches["batch0/tokens"].shape[0])
        ref(None, whole, pick_point=whole.pop("pick"))
        single = float(ref.optimizer.last_grad_norm)
    return {"losses": losses, "state": state, "opt_state": opt_state, "norms": norms,
            "single_norm": single, "specs": specs, "moment_numel": counts,
            "divisible_numel": sum(sizes[n] for n, d in specs.items() if d is not None),
            "replicated_numel": sum(sizes[n] for n, d in specs.items() if d is None)}


def scenario_coati2_tp(root, setup, batches):
    """COATI2 at tensor parallelism 2 (a 1 x 2 mesh): its vocabulary of
    4,266 splits, so the embedding and the head are vocab-parallel."""
    mesh = make_tp_mesh(model_parallel=2, device_type="cpu")
    model, cfg = coati2_model(root, setup)
    config = tt2.Coati2TrainConfig(lr=setup["lr"], clip_grad=setup["clip_grad"],
                                   n_head=setup["coati2"]["n_head"])
    placement = TensorParallelPlacement(mesh, model, config)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    step = tt2.Coati2TrainStep(model, cfg, placement.optimizer,
                               parallel=ttrain.ParallelStep(placement, "pjit"),
                               **setup["step2"])
    losses = []
    for i in range(setup["steps"]):
        batch = rows_of(batches, "c2batch", i, 0, batches[f"c2batch{i}/tokens"].shape[0])
        metrics = step(batch)
        losses.append([float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")])
    specs = {n: (None if s is None else s.dim) for n, s in placement.specs.items()}
    return {"losses": losses, "state": placement.full_state()[0], "specs": specs,
            "local_shapes": shapes}


def scenario_tp_dp(root, setup, batches):
    """COATI at tensor parallelism 2 x data parallelism 2 (world 4),
    "replicated" on the same mesh, which keeps every parameter whole, and
    the rank layout of two hybrid meshes of 2 hosts x 2 ranks."""
    mesh = make_tp_mesh(4, model_parallel=2, device_type="cpu")
    losses, (state, _), _, placement = _run_coati(root, setup, batches, mesh,
                                                  TensorParallelPlacement, "pjit")
    specs = {n: (None if s is None else s.dim) for n, s in placement.specs.items()}
    model, _ = coati_model(root, setup)
    full = {n: tuple(p.shape) for n, p in model.named_parameters()}
    replicated = resolve_placement(mesh, "replicated", "pjit")(mesh, model, train_config(setup))
    kept = all(tuple(p.shape) == full[n] for n, p in replicated.model.named_parameters())
    hybrid = [make_hybrid_mesh(("data", "model"), ici, dcn, device_type="cpu").mesh.tolist()
              for ici, dcn in (((1, 2), (2, 1)), ((2, 1), (1, 2)))]
    return {"losses": losses, "state": state, "specs": specs,
            "replicated_class": type(replicated).__name__, "replicated_keeps_shapes": kept,
            "hybrid": hybrid}


class RankRows:
    """A small dataset of SMILES with random atoms, batched through the
    port's batch_rows (so the rank filter applies)."""

    summary = {"dataset_type": "rank-rows"}
    SMILES = ["C", "CC", "CCO", "CCN", "CCC", "CO", "CN", "OCO", "CCCC", "NCO", "OC", "CCCO"]

    def get_data_pipe(self, batch_size=8, partition="train", required_fields=(),
                      xform_routine=lambda x: x, distributed_rankmod_total=None,
                      distributed_rankmod_rank=1, **kw):
        rng = np.random.default_rng(0)

        def rows():
            for i in range(48):
                smi = self.SMILES[i % len(self.SMILES)]
                n = len(smi)
                yield {"smiles": smi, "source_collection": "geom_drugs",
                       "atoms": rng.integers(1, 9, size=(n,)).astype(np.float64),
                       "coords": rng.normal(size=(n, 3))}

        return batch_rows(rows(), batch_size=batch_size, partition="raw",
                          xform_routine=xform_routine, required_fields=["smiles"],
                          distributed_rankmod_total=distributed_rankmod_total,
                          distributed_rankmod_rank=distributed_rankmod_rank)


def restart_config(root: Path, **kw):
    config = tconfig.TrainConfig(
        n_layer_e3gnn=1, n_hidden_e3nn=16, n_hidden_xformer=16, n_embd_common=16,
        n_layer_xformer=1, n_head=2, n_seq=24, max_n_seq=24, tokenizer_vocab="mar_verysimple",
        batch_size=2, n_epochs=1, lr=1e-3, norm_clips=True, token_mlp=True,
        output_dir=str(root / "out"), model_dir=str(root / "models"),
        p_dataset=0.0, p_formula=0.0, p_fim=0.0, p_graph=0.0, p_clip=0.5, p_randsmiles=0.0,
        log_batch_loss=1, ngrad_to_save=1e9, orbax_dir=str(root / "ckpt"))
    for k, v in kw.items():
        setattr(config, k, v)
    return config


def scenario_restart(root, setup, batches):
    """train_autoencoder at world 2 under FSDP, 3 steps, restart
    checkpoints on; the test resumes it at world 1."""
    import random

    random.seed(dist.get_rank())
    mesh = make_mesh(axis_names=("data",), device_type="cpu")
    model, results = ttrain.train_autoencoder(
        restart_config(root, param_sharding="fsdp"), RankRows(), device="cpu",
        max_steps_per_epoch=3, mesh=mesh)
    return {"history": results["history"],
            "params": {n: p.detach().clone() for n, p in model.named_parameters()}}


SCENARIOS = {
    "dp": scenario_dp,
    "clip_gradient": scenario_clip_gradient,
    "fsdp": scenario_fsdp,
    "coati2_tp": scenario_coati2_tp,
    "tp_dp": scenario_tp_dp,
    "restart": scenario_restart,
}


def rank_main(rank: int, world: int, root: str, scenarios) -> None:
    """One rank: join the gloo world, run the scenarios, rank 0 saves."""
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / f'rendezvous{world}'}",
                            rank=rank, world_size=world)
    try:
        setup, batches = load_setup(root)
        results = {name: SCENARIOS[name](root, setup, batches) for name in scenarios}
        if rank == 0:
            torch.save(results, root / f"results{world}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(root: Path, world: int, scenarios, timeout: float = JOIN_SECONDS) -> dict:
    """Spawn `world` ranks running `scenarios`, join each within `timeout`
    seconds (killing what is left), check every exit code, and return rank
    0's results."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(rank_main, args=(world, str(root), list(scenarios)), nprocs=world,
                   join=False)
    try:
        for proc in ctx.processes:
            proc.join(timeout)
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    codes = [proc.exitcode for proc in ctx.processes]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return torch.load(root / f"results{world}.pt", weights_only=False)

