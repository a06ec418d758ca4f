"""One step of every parallel strategy over n devices, at tiny shapes.

PyTorch counterpart of coati_tpu's `dryrun_multichip` (__graft_entry__.py).
Five legs, each from a seeded model and one optimizer step:

  1. dp x tp: the COATI train step over a (data, model = 2) mesh with
     tensor parallelism (parallel/tp.py), pure data parallelism when n is
     odd or below 4;
  2. fsdp: the same step with parameters and moments sharded over data;
  3. dp x pp: the composite COATI step (EGNN, both trunk passes, AR and
     global CLIP losses) over (data, pipe = 2) (parallel/pp.py);
  4. dp x sp: the ring-attention AR train step over (data, seq = 2)
     (parallel/sp.py);
  5. dp x ep: the MoE train step over (data, expert = 2) (parallel/ep.py).

Legs 3-5 need an even n. Each leg asserts its loss and parameters finite and
rank 0 prints `dryrun_multichip(n) <leg> OK: loss=...`.

`dryrun_multichip(n)` runs on the ranks of an initialised world of n ranks,
each on parallel/mesh.py's rank_device (a card when CUDA is there, gloo
ranks sharing it); with none initialised it spawns n gloo ranks (on the CPU
when no card is there), joins each within a limit and returns rank 0's
losses.
"""

from __future__ import annotations

import json
import tempfile
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

JOIN_SECONDS = 600


def _synthetic_batch(tok, batch: int, width: int, n_atoms: int, seed: int = 0):
    """coati_tpu's dry-run batch: random tokens between [SMILES] and [STOP],
    a pad at the end, random atoms and coordinates."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(len(tok.special_tokens), tok.n_token, size=(batch, width))
    tokens[:, 0] = tok.smiles_token
    tokens[:, -2] = tok.stop_token
    tokens[:, -1] = tok.pad_token
    y_next = np.zeros_like(tokens)
    y_next[:, :-1] = tokens[:, 1:]
    y_next[y_next == tok.pad_token] = -1
    atoms = rng.integers(1, 9, size=(batch, n_atoms))
    coords = rng.normal(size=(batch, n_atoms, 3)).astype(np.float32)
    return tokens, y_next, atoms, coords


def _finite(loss: torch.Tensor, params, leg: str) -> float:
    value = float(loss)
    assert np.isfinite(value), f"{leg}: non-finite loss {value}"
    assert all(bool(torch.isfinite(p).all()) for p in params), f"{leg}: non-finite parameters"
    return value


def _legs(n_devices: int, device: torch.device) -> Dict[str, float]:
    from coati_tpu_torch.models.transformer import SmilesTransformer, TransformerConfig
    from coati_tpu_torch.parallel import ep, pp, sp
    from coati_tpu_torch.parallel.fsdp import FullyShardedPlacement
    from coati_tpu_torch.parallel.mesh import make_mesh
    from coati_tpu_torch.parallel.placement import ReplicatedPlacement
    from coati_tpu_torch.parallel.tp import TensorParallelPlacement, make_tp_mesh
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import TrainConfig

    tok = TrieTokenizer(n_seq=32, **get_vocab("mar_verysimple"))
    config = TrainConfig(n_layer_e3gnn=2, n_layer_xformer=2, n_hidden_xformer=32,
                         n_hidden_e3nn=32, n_embd_common=32, n_head=2, n_seq=32, max_n_seq=32,
                         norm_clips=True, token_mlp=True, xformer_remat=True, lr=1e-3)
    model_cfg = train.model_config_from_train_config(config, tok.n_token)
    tokens, y_next, atoms, coords = _synthetic_batch(tok, 2 * n_devices, 16, 8)
    host = {"raw_tokens": tokens, "tokens": tokens, "y_next": y_next, "atoms": atoms,
            "coords": coords}
    step_kw = dict(stop_token=tok.stop_token, unk_token=tok.unk_token, p_clip_emb_smi=0.4,
                   token_entropy_unit=float(np.log2(tok.n_token)))
    even = n_devices % 2 == 0
    out = {}

    def rows(n_data, data_rank):
        lo, hi = data_rank * len(tokens) // n_data, (data_rank + 1) * len(tokens) // n_data
        return train.batch_to_device({k: v[lo:hi] for k, v in host.items()}, device)

    def announce(leg, loss):
        out[leg] = loss
        if dist.get_rank() == 0:
            print(f"dryrun_multichip({n_devices}) {leg} OK: loss={loss:.4f}", flush=True)

    def placed_step(leg, mesh, cls):
        model = train.fresh_model(model_cfg, device, seed=0)
        placement = cls(mesh, model, config)
        step = train.TrainStep(model, model_cfg, placement.optimizer, do_clip=True,
                               parallel=train.ParallelStep(placement, "pjit"), **step_kw)
        axes = placement.axes
        generator = torch.Generator(device=device).manual_seed(1 + axes.data_rank)
        metrics = step(generator, rows(axes.n_data, axes.data_rank))
        announce(leg, _finite(metrics["loss"], model.parameters(), leg))

    # 1. dp x tp (pure dp when the ranks do not pair up)
    if n_devices >= 4 and even:
        placed_step("dp x tp", make_tp_mesh(n_devices, model_parallel=2),
                    TensorParallelPlacement)
    else:
        placed_step("dp", make_mesh(n_devices), ReplicatedPlacement)
    # 2. fsdp over a pure data mesh
    placed_step("fsdp", make_mesh(n_devices), FullyShardedPlacement)
    if not even:
        return out

    # 3. dp x pp: the composite COATI step
    mesh = pp.make_pp_mesh(n_devices, pipe=2)
    model = pp.shard_coati_params_pp(mesh, train.fresh_model(model_cfg, device, seed=2))
    step = pp.make_pp_coati_train_step(mesh, model_cfg, model,
                                       pp.make_pp_optimizer(config, mesh, model),
                                       n_microbatches=2, **step_kw)
    n_data, data_rank = mesh.size(0), mesh.get_local_rank("data")
    generator = torch.Generator(device=device).manual_seed(1 + data_rank)
    metrics = step(generator, rows(n_data, data_rank))
    announce("dp x pp", _finite(metrics["loss"], model.parameters(), "dp x pp"))

    # 4. dp x sp: the ring-attention AR step
    tcfg = TransformerConfig(n_layer=2, n_embd=32, n_head=2, n_seq=16, n_tok=tok.n_token)
    tok2, ynext2, _, _ = _synthetic_batch(tok, 2 * n_devices, 16, 4)
    mesh = sp.make_sp_mesh(n_devices, seq=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        trunk = SmilesTransformer(tcfg).to(device)
    step = sp.make_sp_train_step(mesh, tcfg, trunk, train.make_optimizer(config, trunk))
    n_data, data_rank = mesh.size(0), mesh.get_local_rank("data")
    lo, hi = data_rank * len(tok2) // n_data, (data_rank + 1) * len(tok2) // n_data
    loss = step(torch.as_tensor(tok2[lo:hi], device=device),
                torch.as_tensor(ynext2[lo:hi], device=device))
    announce("dp x sp", _finite(loss, trunk.parameters(), "dp x sp"))

    # 5. dp x ep: the MoE step
    mesh = ep.make_ep_mesh(n_devices, expert=2)
    gen = torch.Generator(device=device).manual_seed(3)
    moe = ep.shard_params_ep(mesh, ep.init_moe(gen, 32, 64, 4, device=device))
    x = torch.randn((2 * n_devices, 16, 32), generator=gen, device=device)
    n_data, data_rank = mesh.size(0), mesh.get_local_rank("data")
    lo, hi = data_rank * len(x) // n_data, (data_rank + 1) * len(x) // n_data
    optimizer = train.make_optimizer(config, moe, grad_norm=ep.ep_grad_norm(mesh, moe))
    loss = ep.make_ep_train_step(mesh, moe, optimizer)(x[lo:hi])
    announce("dp x ep", _finite(loss, moe.parameters(), "dp x ep"))
    return out


def _rank(rank: int, n_devices: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{Path(root) / 'rendezvous'}",
                            rank=rank, world_size=n_devices)
    try:
        losses = dryrun_multichip(n_devices)
        if rank == 0:
            (Path(root) / "losses.json").write_text(json.dumps(losses))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = JOIN_SECONDS) -> Dict[str, float]:
    """The five legs over n ranks; returns {leg: loss}. Inside an
    initialised world of n ranks each rank runs its part on its device;
    without one, n gloo ranks are spawned, each joined within
    `timeout` seconds (what is left is killed) and their exit codes checked."""
    if dist.is_initialized():
        from coati_tpu_torch.parallel.mesh import rank_device

        world = dist.get_world_size()
        if world != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a world of {world} ranks")
        return _legs(n_devices, rank_device())
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as root:
        ctx = mp.spawn(_rank, args=(n_devices, root), nprocs=n_devices, join=False)
        try:
            for proc in ctx.processes:
                proc.join(timeout)
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join(10)
        codes = [proc.exitcode for proc in ctx.processes]
        if codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {codes}")
        return json.loads((Path(root) / "losses.json").read_text())
