"""Pipeline parallelism over the transformer trunk.

PyTorch counterpart of coati_tpu/parallel/pp.py: a GPipe schedule over a
`pipe` mesh axis, composed with data parallelism on a (data, pipe) mesh,
the batch split over `data` and the trunk's layers over `pipe`. Stage s
holds layers [s L / S, (s + 1) L / S); everything else (embedding, final
LayerNorm, lm_head, the EGNN, the projections, the token MLP) is replicated
on every rank. `shard_params_pp` leaves a rank only its stage's blocks: the
others become `Elsewhere` placeholders, so that a rank's state dict keeps
the reference's key of every layer it holds (models/convert.py
`stage_state` / `merge_stage_states` slice and join whole states).

Schedule (S stages, M microbatches, M + S - 1 ticks): at tick t stage s
runs its layers on microbatch t - s; stage 0 takes the embedding of
microbatch t, every other stage what stage s - 1 sent at tick t - 1
(comm.ring_permute, i -> i + 1 mod S); the last stage keeps its finished
microbatch.

As in coati_tpu, every rank runs the same program (SPMD): ticks where a
stage holds no microbatch compute on what it was sent (zeros, or what the
wrap-around carried), and selections (torch.where on the stage index) keep
their results out of the output and the loss. The port keeps those ticks
rather than skipping them: every rank then builds the same autograd graph,
so the backward runs the ring's reverse permutes and the losses'
all-reduces in the same order on every rank, which collectives require.

The losses sum over the mesh with comm.all_reduce_sum where coati_tpu
psums inside the differentiated function: the AR loss on the last stage,
the CLIP loss on stage 0 (over the data-gathered batch), the [STOP] hidden
state from the last stage. Each such sum's backward all-reduces its
cotangent (psum's transpose), and every rank seeds the backward of the
loss, so a rank's gradient is data x pipe times its share of the global
gradient (coati_tpu's gradient is that multiple of the single-device one:
optax.adam does not see the scale, a global-norm clip does). The port
reduces the gradients (every leaf summed over data, replicated leaves over
pipe as well, blocks staying on their stage) and divides them by the mesh
size, so that the step is the single-device step, clip included;
`make_pp_optimizer`'s clip counts each stage's blocks once and each
replicated leaf once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from coati_tpu_torch.models import coati as F
from coati_tpu_torch.models.convert import layer_index, merge_stage_states
from coati_tpu_torch.models.transformer import (
    SmilesTransformer,
    TransformerConfig,
    _block_full,
    _check_kernel_fields,
    _lm_head,
    _rotary,
    embed_tokens,
    stop_token_hidden,
)
from coati_tpu_torch.ops.layers import cast_floats, layer_norm
from coati_tpu_torch.parallel.comm import (
    all_gather_rows,
    all_reduce_,
    all_reduce_sum,
    gather_rows,
    ring_permute,
)
from coati_tpu_torch.parallel.mesh import axis_groups, make_axis_mesh
from coati_tpu_torch.parallel.placement import average_, fill_missing_grads, squared_norm


class Elsewhere(nn.Module):
    """The place of a block that another pipeline stage holds."""


def make_pp_mesh(n_devices: Optional[int] = None, pipe: int = 2,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(data = n / pipe) x (pipe); a pipe group holds neighbouring ranks."""
    return make_axis_mesh("pipe", pipe, n_devices, device_type)


def pp_param_specs(model: nn.Module):
    """{parameter name: "pipe" for a trunk block's leaf (sharded by layer),
    None for a replicated one}, for a SmilesTransformer or a CoatiModel."""
    return {name: ("pipe" if layer_index(name) is not None else None)
            for name, _ in model.named_parameters()}


def pp_coati_param_specs(model: nn.Module):
    """The composite model's specs: the trunk's blocks over `pipe`, the
    EGNN, projections, token MLP, embedding, final LN and lm_head
    replicated."""
    return pp_param_specs(model)


def stage_layers(n_layer: int, n_stages: int, stage: int) -> range:
    """The layers stage `stage` holds."""
    per = n_layer // n_stages
    return range(stage * per, (stage + 1) * per)


def _trunk(model: nn.Module) -> SmilesTransformer:
    return model if isinstance(model, SmilesTransformer) else model.xformer


def shard_params_pp(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    """Keep only this rank's stage of the trunk's blocks (in place); the
    model must hold the same weights on every rank (a seeded or converted
    model, or parallel/mesh.py replicate_params)."""
    _, _, _, n_stages, _, stage = axis_groups(mesh, "pipe")
    blocks = _trunk(model).transformer.h
    n_layer = len(blocks)
    if n_layer % n_stages:
        raise ValueError(f"n_layer {n_layer} must divide evenly into {n_stages} pipeline stages")
    mine = stage_layers(n_layer, n_stages, stage)
    for i in range(n_layer):
        if i not in mine:
            blocks[i] = Elsewhere()
    return model


def shard_coati_params_pp(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    return shard_params_pp(mesh, model)


class _Pipe:
    """The (data, pipe) groups of a mesh and this rank's place in them."""

    def __init__(self, mesh: DeviceMesh):
        (self.data, self.pipe, self.n_data, self.n_stages, self.data_rank,
         self.stage) = axis_groups(mesh, "pipe")

    def flags(self, device):
        """(is stage 0, is the last stage) as 0-d bool tensors."""
        return (torch.tensor(self.stage == 0, device=device),
                torch.tensor(self.stage == self.n_stages - 1, device=device))


def _stage_hidden(params: SmilesTransformer, cfg: TransformerConfig, tokens: torch.Tensor,
                  n_microbatches: int, pipe: _Pipe, injection=None, inject_token=None):
    """This rank's GPipe schedule over its rows. tokens: (B, T). Returns the
    final-LN hidden (B, T, D), valid on the last stage only (zeros on the
    others; callers mask, or sum over the pipe axis)."""
    _check_kernel_fields(cfg)
    b, t = tokens.shape
    m_count, s_count, s = n_microbatches, pipe.n_stages, pipe.stage
    if b % m_count:
        raise ValueError(f"{b} rows do not split into {m_count} microbatches")
    bm, d = b // m_count, cfg.n_embd
    params = cast_floats(params, cfg.compute_dtype)
    cos, sin = _rotary(cfg, tokens.device)
    first, last = pipe.flags(tokens.device)
    blocks = [params.transformer.h[i] for i in stage_layers(cfg.n_layer, s_count, s)]
    remat = cfg.remat and torch.is_grad_enabled()

    def run_local_blocks(x):
        for blk in blocks:
            if remat:
                x = checkpoint(_block_full, x, blk, cfg, cos, sin, use_reentrant=False)
            else:
                x = _block_full(x, blk, cfg, cos, sin)
        return x

    # every stage embeds (one gather); the selection lets only stage 0's
    # flow on, which also leaves the other stages' embedding gradient zero
    emb = embed_tokens(params, cfg, tokens, injection, inject_token).reshape(m_count, bm, t, d)
    buf = torch.zeros((bm, t, d), dtype=cfg.compute_dtype, device=tokens.device)
    out = [torch.zeros_like(buf) for _ in range(m_count)]
    n_ticks = m_count + s_count - 1
    for tick in range(n_ticks):
        m = tick - s
        x = run_local_blocks(torch.where(first, emb[min(tick, m_count - 1)], buf))
        write = min(max(m, 0), m_count - 1)
        active = torch.tensor(0 <= m < m_count, device=tokens.device) & last
        out[write] = torch.where(active, x, out[write])
        if tick < n_ticks - 1:  # the last tick's rotation would carry nothing used
            buf = ring_permute(x, pipe.pipe)
    lnf = params.transformer.ln_f
    hidden = layer_norm(torch.cat(out).reshape(b, t, d), lnf.weight, lnf.bias)
    return torch.where(last, hidden, torch.zeros_like(hidden))


def make_pp_forward_logits(mesh: DeviceMesh, cfg: TransformerConfig, model: nn.Module,
                           n_microbatches: int, inject_token: Optional[int] = None):
    """The pipelined forward: fn(tokens[, injection]) -> logits (B, T, V) of
    this data rank's rows, on every stage; equal to
    transformer.forward_logits of the whole model. `model` is a trunk (or a
    CoatiModel, whose trunk runs) after shard_params_pp."""
    pipe = _Pipe(mesh)
    trunk = _trunk(model)

    def fn(tokens, injection=None):
        hidden = _stage_hidden(trunk, cfg, tokens, n_microbatches, pipe,
                               injection if inject_token is not None else None, inject_token)
        hidden = all_reduce_sum(hidden, pipe.pipe)
        return _lm_head(cast_floats(trunk, cfg.compute_dtype), cfg, hidden)

    return fn


def _masked_ar(logits, y_next, last, pipe: _Pipe):
    """The AR loss: the last stage's summed token losses over the mesh's
    valid tokens (sums over pipe and data)."""
    total, count = F.nll_sum_and_count(logits.reshape(-1, logits.shape[-1]), y_next.reshape(-1))
    total = torch.where(last, total, torch.zeros_like(total))
    count = torch.where(last, count, torch.zeros_like(count))
    total = all_reduce_sum(all_reduce_sum(total, pipe.pipe), pipe.data)
    count = all_reduce_(all_reduce_(count.clone(), pipe.pipe), pipe.data)
    return total / count.clamp_min(1)


class _PipelineStep:
    """The update shared by the two train steps: the gradient reduction of
    the module docstring and the optimizer's step."""

    def __init__(self, mesh: DeviceMesh, model: nn.Module, optimizer):
        self.pipe = _Pipe(mesh)
        self.optimizer = optimizer
        specs = pp_param_specs(model)
        named = list(model.named_parameters())
        self.blocks = [p for n, p in named if specs[n] is not None]
        self.replicated = [p for n, p in named if specs[n] is None]

    def update(self) -> None:
        pipe = self.pipe
        fill_missing_grads(self.blocks + self.replicated)
        # sums over data, and over pipe for the replicated leaves, each
        # divided by the mesh size: means over both axes, the blocks' sum
        # over the one stage that holds them divided by S
        average_([p.grad for p in self.blocks + self.replicated], pipe.data, pipe.n_data)
        average_([p.grad for p in self.replicated], pipe.pipe, pipe.n_stages)
        if self.blocks and pipe.n_stages > 1:
            torch._foreach_mul_([p.grad for p in self.blocks], 1.0 / pipe.n_stages)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)


def pp_grad_norm(mesh: DeviceMesh, model: nn.Module):
    """() -> the global norm of the whole gradient after the reduction:
    each stage's blocks counted once (their squares summed over pipe), each
    replicated leaf once."""
    _, pipe_group, *_ = axis_groups(mesh, "pipe")
    specs = pp_param_specs(model)
    named = list(model.named_parameters())

    def norm():
        blocks = squared_norm([p.grad for n, p in named if specs[n] is not None])
        all_reduce_(blocks, pipe_group)
        return (blocks + squared_norm([p.grad for n, p in named if specs[n] is None])).sqrt()

    return norm


def make_pp_optimizer(config, mesh: DeviceMesh, model: nn.Module):
    """ClippedAdamW over this rank's parameters whose clip sees the whole
    gradient (pp_grad_norm)."""
    from coati_tpu_torch.training.train import make_optimizer

    return make_optimizer(config, model, grad_norm=pp_grad_norm(mesh, model))


def make_pp_coati_train_step(mesh: DeviceMesh, model_cfg, model: nn.Module, optimizer, *,
                             stop_token: int, unk_token: int, p_clip_emb_smi: float,
                             token_entropy_unit: float, n_microbatches: int):
    """DP x PP train step of the whole COATI model: the EGNN point encoder,
    both trunk passes through the pipe, the projections, the AR and global
    CLIP losses. `model` is a CoatiModel after shard_coati_params_pp,
    `optimizer` make_pp_optimizer's over it. Returns step(generator, batch,
    pick_point=None) -> {loss, ar_loss, clip_loss} (0-d tensors, the global
    values on every rank), which updates the model in place; batch is this
    data rank's rows (raw_tokens, tokens, y_next, atoms, coords), the same
    on every stage. The trunk runs the config's attention route, and the
    EGNN K3 forward and K4 backward, as the single-device trainer does."""
    update = _PipelineStep(mesh, model, optimizer)
    pipe = update.pipe
    xcfg = model_cfg.xformer_config

    def losses(generator, batch, pick_point):
        params = F._cast_once(model, model_cfg)
        first, last = pipe.flags(batch["tokens"].device)
        # replicated encoders: every stage computes them
        h_e3gnn = F.encode_points(params, model_cfg, batch["atoms"], batch["coords"])
        # trunk pass 1 (clean tokens); the [STOP] hidden state of the last
        # stage, summed over pipe so that every stage holds it
        hidden = _stage_hidden(params.xformer, xcfg, batch["raw_tokens"], n_microbatches, pipe)
        h_stop = all_reduce_sum(stop_token_hidden(hidden, batch["raw_tokens"], stop_token),
                                pipe.pipe)
        h_smiles = F.apply_projection(params.smiles_to_clip, h_stop, model_cfg.old_architecture)
        point_tok = F.clip_to_special_token(params, h_e3gnn)
        smiles_tok = F.clip_to_special_token(params, h_smiles)
        pick = F._pick_point(h_e3gnn.shape[0], p_clip_emb_smi, h_e3gnn.device, generator,
                             pick_point)
        clip_token = torch.where(pick, point_tok, smiles_tok)
        # trunk pass 2 (augmented tokens, the clip token injected)
        hidden2 = _stage_hidden(params.xformer, xcfg, batch["tokens"], n_microbatches, pipe,
                                clip_token, unk_token)
        ar = _masked_ar(_lm_head(params.xformer, xcfg, hidden2), batch["y_next"], last, pipe)
        # the global CLIP loss, taken on stage 0 only, so that one stage's
        # copy of the replicated encoders receives its gradient
        bad = batch["tokens"].sum(dim=-1) < 1
        cl = F.clip_loss(all_gather_rows(h_smiles, pipe.data), all_gather_rows(h_e3gnn, pipe.data),
                         gather_rows(bad, pipe.data))
        cl = all_reduce_sum(torch.where(first, cl, torch.zeros_like(cl)), pipe.pipe)
        return ar + cl * token_entropy_unit, ar, cl

    def step(generator, batch, pick_point=None):
        loss, ar, cl = losses(generator, batch, pick_point)
        loss.backward()
        update.update()
        return {"loss": loss.detach(), "ar_loss": ar.detach(), "clip_loss": cl.detach()}

    return step


def make_pp_ar_train_step(mesh: DeviceMesh, cfg: TransformerConfig, model: nn.Module, optimizer,
                          *, n_microbatches: int):
    """DP x PP autoregressive train step of a bare trunk (after
    shard_params_pp): step(tokens, y_next) -> {"loss"}; the cross-entropy
    is taken on the last stage, so full logits never leave a rank."""
    update = _PipelineStep(mesh, model, optimizer)
    pipe = update.pipe

    def step(tokens, y_next):
        _, last = pipe.flags(tokens.device)
        params = cast_floats(model, cfg.compute_dtype)
        hidden = _stage_hidden(params, cfg, tokens, n_microbatches, pipe)
        loss = _masked_ar(_lm_head(params, cfg, hidden), y_next, last, pipe)
        loss.backward()
        update.update()
        return {"loss": loss.detach()}

    return step


def gather_stages(mesh: DeviceMesh, tensors):
    """Every stage's {state-dict key: tensor} (parameters, or their
    gradients) joined into the whole model's, on the CPU (a collective over
    pipe)."""
    _, pipe_group, _, n_stages, *_ = axis_groups(mesh, "pipe")
    mine = {k: v.detach().cpu() for k, v in tensors.items()}
    if n_stages == 1:
        return mine
    states = [None] * n_stages
    torch.distributed.all_gather_object(states, mine, group=pipe_group)
    return merge_stage_states(states)


def gather_pp_state(mesh: DeviceMesh, model: nn.Module):
    """The whole model's state dict, in the single-device layout."""
    return gather_stages(mesh, model.state_dict())
