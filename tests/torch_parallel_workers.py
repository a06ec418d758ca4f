"""The rank side of tests/test_torch_parallel.py, free of JAX: it runs in
processes started by torch.multiprocessing.spawn, one a rank, over gloo on
the CPU (init_method file://, one torch thread a rank).

The test process writes, under one directory: `setup.json` (the model
sizes, the learning rate, the clip), `weights.npz` / `weights2.npz` (the
port's state dicts of one COATI and one COATI2, numpy, keyed by the
reference's names), `batches.npz` (the global batches of each step and
the clip-token choices, and the inputs of the pipeline, sequence and expert
scenarios under `trunk/`, `sp/` and `ep/`) and `moe.npz` (one MoeParams).
Each rank runs the scenarios named for its world on its rows of every
global batch; rank 0 writes `results<world>.pt`."""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from coati_tpu_torch.data.batch_pipe import batch_rows
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import coati2 as t2
from coati_tpu_torch.models.convert import moe_from_coati_tpu
from coati_tpu_torch.parallel import ep as tep
from coati_tpu_torch.parallel import pp as tpp
from coati_tpu_torch.parallel import sp as tsp
from coati_tpu_torch.parallel.comm import all_gather_rows, gather_rows, permute_route, ring_permute
from coati_tpu_torch.parallel.dryrun import dryrun_multichip
from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement, fsdp_specs
from coati_tpu_torch.parallel.mesh import axis_groups, make_hybrid_mesh, make_mesh
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


class CaptureGradients:
    """An optimizer that only keeps the gradients it is handed: the reduced
    gradients of a step, before any update."""

    def __init__(self, named_parameters):
        self.named = list(named_parameters)
        self.grads = None

    def step(self):
        self.grads = {n: p.grad.detach().clone() for n, p in self.named}

    def zero_grad(self, set_to_none=True):
        for _, p in self.named:
            p.grad = None


def _data_rows(batches, key, n_data, data_rank):
    v = batches[key]
    lo, hi = data_rank * len(v) // n_data, (data_rank + 1) * len(v) // n_data
    return torch.tensor(v[lo:hi])


def scenario_pp(root, setup, batches):
    """The composite COATI step over (data, pipe = 2): the steps of the
    saved batches (world 2: one data rank with the global batch's clip
    choices; world 4: two, with the per-rank choices coati_tpu's pipelined
    step draws), the reduced gradients of the first step, and the
    permute's routes."""
    mesh = tpp.make_pp_mesh(pipe=2, device_type="cpu")
    _, pipe_group, n_data, _, data_rank, stage = axis_groups(mesh, "pipe")
    pick_key = "pick" if n_data == 1 else "pick_shard"

    def run(optimizer_of, steps):
        model, cfg = coati_model(root, setup)
        tpp.shard_coati_params_pp(mesh, model)
        optimizer = optimizer_of(model)
        step = tpp.make_pp_coati_train_step(mesh, cfg, model, optimizer, n_microbatches=2,
                                            **{k: v for k, v in setup["step"].items()
                                               if k != "do_clip"})
        losses, norms = [], []
        for i in range(steps):
            rows = batches[f"batch{i}/tokens"].shape[0]
            lo, hi = data_rank * rows // n_data, (data_rank + 1) * rows // n_data
            batch = rows_of(batches, "batch", i, lo, hi)
            pick = batch[pick_key]
            batch = {k: v for k, v in batch.items() if not k.startswith("pick")}
            metrics = step(None, batch, pick_point=pick)
            losses.append([float(metrics[k]) for k in ("loss", "ar_loss", "clip_loss")])
            norms.append(float(getattr(optimizer, "last_grad_norm", 0.0) or 0.0))
        return model, optimizer, losses, norms

    model, _, losses, norms = run(lambda m: tpp.make_pp_optimizer(train_config(setup), mesh, m),
                                  setup["steps"])
    state = tpp.gather_pp_state(mesh, model)
    model, capture, _, _ = run(lambda m: CaptureGradients(m.named_parameters()), 1)
    grads = tpp.gather_stages(mesh, capture.grads)
    local_keys = sorted(k for k, _ in model.named_parameters())
    # the permute by both routes (the card's gloo ranks take the all-gather)
    permuted = {}
    for route in ("p2p", "all_gather"):
        x = torch.full((2,), float(stage), requires_grad=True)
        y = ring_permute(x, pipe_group, route=route)
        (y * (stage + 1)).sum().backward()
        permuted[route] = (y.tolist(), x.grad.tolist())
    return {"losses": losses, "state": state, "norms": norms, "grads": grads,
            "stage_keys": local_keys if stage == 0 else None,
            "route": permute_route(x, pipe_group), "permuted": permuted}


def scenario_pp_ar(root, setup, batches):
    """The bare trunk over (data, pipe = 2): pipelined logits with and
    without injection (2 and 4 microbatches), one AR step, and the reduced
    gradients of that step."""
    mesh = tpp.make_pp_mesh(pipe=2, device_type="cpu")
    data_group, _, n_data, _, data_rank, _ = axis_groups(mesh, "pipe")
    tokens = _data_rows(batches, "trunk/tokens", n_data, data_rank).long()
    y_next = _data_rows(batches, "trunk/y_next", n_data, data_rank).long()
    inj = _data_rows(batches, "trunk/inj", n_data, data_rank)
    out = {}

    def trunk():
        model, cfg = coati_model(root, setup)
        return tpp.shard_params_pp(mesh, model.xformer), cfg.xformer_config

    model, xcfg = trunk()
    with torch.no_grad():
        for m in (2, 4):
            out[f"logits{m}"] = gather_rows(
                tpp.make_pp_forward_logits(mesh, xcfg, model, m)(tokens), data_group)
        fwd = tpp.make_pp_forward_logits(mesh, xcfg, model, 2, inject_token=setup["inject"])
        out["logits_inj"] = gather_rows(fwd(tokens, inj), data_group)
    optimizer = tpp.make_pp_optimizer(train_config(setup), mesh, model)
    out["loss"] = float(tpp.make_pp_ar_train_step(mesh, xcfg, model, optimizer,
                                                  n_microbatches=2)(tokens, y_next)["loss"])
    out["state"] = tpp.gather_pp_state(mesh, model)
    model, xcfg = trunk()
    capture = CaptureGradients(model.named_parameters())
    tpp.make_pp_ar_train_step(mesh, xcfg, model, capture, n_microbatches=2)(tokens, y_next)
    out["grads"] = tpp.gather_stages(mesh, capture.grads)
    return out


def scenario_sp(root, setup, batches):
    """The trunk over (data, seq = 2): logits with and without injection,
    ring attention's gradients, one AR step, the encode, and the guards."""
    mesh = tsp.make_sp_mesh(seq=2, device_type="cpu")
    data_group, seq_group, n_data, n_shards, data_rank, shard = axis_groups(mesh, "seq")
    model, cfg = coati_model(root, setup)
    trunk, xcfg = model.xformer, cfg.xformer_config
    tokens = _data_rows(batches, "sp/tokens", n_data, data_rank).long()
    y_next = _data_rows(batches, "sp/y_next", n_data, data_rank).long()
    inj = _data_rows(batches, "sp/inj", n_data, data_rank)
    enc = _data_rows(batches, "sp/enc_tokens", n_data, data_rank).long()
    out = {}
    with torch.no_grad():
        out["logits"] = gather_rows(tsp.make_sp_forward_logits(mesh, xcfg, trunk)(tokens),
                                    data_group)
        fwd = tsp.make_sp_forward_logits(mesh, xcfg, trunk, inject_token=setup["inject"])
        out["logits_inj"] = gather_rows(fwd(tokens, inj), data_group)
        out["encode"] = gather_rows(
            tsp.make_sp_encode(mesh, xcfg, trunk, setup["step"]["stop_token"])(enc), data_group)
    # ring attention alone: this shard's rows, the gradients gathered over seq
    t = batches["sp/q"].shape[1] // n_shards
    q, k, v = (torch.tensor(batches[f"sp/{n}"][:, shard * t:(shard + 1) * t]).requires_grad_(True)
               for n in ("q", "k", "v"))
    att = tsp.ring_causal_attention(q, k, v, seq_group)
    att.square().sum().backward()

    def whole(a):  # the shards of (B, T_local, ...) in sequence order
        return gather_rows(a.detach().transpose(0, 1).contiguous(), seq_group).transpose(0, 1)

    out["ring_out"] = whole(att)
    out["ring_grads"] = [whole(g) for g in (q.grad, k.grad, v.grad)]
    # one AR step
    optimizer = ttrain.make_optimizer(train_config(setup), trunk)
    out["loss"] = float(tsp.make_sp_train_step(mesh, xcfg, trunk, optimizer)(tokens, y_next))
    out["state"] = {k: v.detach().clone() for k, v in trunk.state_dict().items()}
    # the guards
    errors = []
    for width in (2 * xcfg.n_seq, xcfg.n_seq - 1):
        try:
            tsp.make_sp_forward_logits(mesh, xcfg, trunk)(torch.zeros((2, width),
                                                                      dtype=torch.long))
        except ValueError as ex:
            errors.append(str(ex))
    out["errors"] = errors
    return out


def scenario_ep(root, setup, batches):
    """The MoE over (data, expert = 2) with a binding capacity: the output,
    the load-balance loss and the gradients of sum(out^2) + 0.01 aux, the
    experts' gathered over the expert group."""
    mesh = tep.make_ep_mesh(expert=2, device_type="cpu")
    data_group, expert_group, n_data, _, data_rank, _ = axis_groups(mesh, "expert")
    whole = moe_from_coati_tpu(dict(np.load(root / "moe.npz")), device="cpu")
    params = tep.shard_params_ep(mesh, whole)
    x = _data_rows(batches, "ep/x", n_data, data_rank)
    cf = setup["moe_cf"]
    with torch.no_grad():
        out, aux = tep.moe_mlp(params, x, cf, data_group, expert_group)
    capture = CaptureGradients(params.named_parameters())
    loss = tep.make_ep_train_step(mesh, params, capture, cf)(x)
    grads = {n: (g if n == "router" else gather_rows(g, expert_group))
             for n, g in capture.grads.items()}
    return {"out": gather_rows(out, data_group), "aux": float(aux), "loss": float(loss),
            "grads": grads, "local_experts": int(params.w_fc.shape[0])}


def scenario_dryrun(root, setup, batches):
    """coati_tpu_torch.parallel.dryrun over this world, and what rank 0
    printed."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        losses = dryrun_multichip(dist.get_world_size())
    return {"losses": losses, "lines": printed.getvalue().splitlines()}


SCENARIOS = {
    "dp": scenario_dp,
    "clip_gradient": scenario_clip_gradient,
    "fsdp": scenario_fsdp,
    "coati2_tp": scenario_coati2_tp,
    "tp_dp": scenario_tp_dp,
    "restart": scenario_restart,
    "pp": scenario_pp,
    "pp_ar": scenario_pp_ar,
    "sp": scenario_sp,
    "ep": scenario_ep,
    "dryrun": scenario_dryrun,
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

