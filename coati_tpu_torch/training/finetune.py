"""LoRA fine-tuning of a trained COATI trunk.

Counterpart of coati_tpu/training/finetune.py: low-rank adapters
(arXiv:2106.09685) over the transformer blocks' weight matrices,

    W_eff = W + (alpha / r) * A @ B      A: (L, in, r), B: (L, r, out)

per layer, in coati_tpu's (in, out) orientation. The port's blocks hold
nn.Linear weights of shape (out, in) (`attn.c_attn`, `attn.c_proj`,
`mlpf.0`, `mlpf.2`), so the delta goes in transposed. The adapters keep
coati_tpu's target names (w_attn, w_proj, w_fc, w_out), so one carries
across as it is (models/convert.lora_from_coati_tpu).

Design, as in coati_tpu: the adapters are merged into the frozen trunk
before each forward instead of rewiring the model. `merge_lora` returns a
structural copy of the trunk (the same module classes, so every function
that takes a trunk takes it) whose parameters are the base tensors
detached, shared and not copied, and, for each target, the merged weight
computed from the adapters. A loss through it has gradients in the
adapters only: the base gets none. The copy's state_dict is a plain trunk
state dict, so `merged_model` is also the export: a document written from
it loads everywhere.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from coati_tpu_torch.models.coati import ar_loss_fn
from coati_tpu_torch.models.transformer import SmilesTransformer, forward_logits

# coati_tpu's name of each target -> the nn.Linear of a block that holds it
TARGETS = {
    "w_attn": "attn.c_attn",
    "w_proj": "attn.c_proj",
    "w_fc": "mlpf.0",
    "w_out": "mlpf.2",
}


class LoraParams(nn.Module):
    """Rank-r adapters over the blocks' weights: `a[name]` (L, in, r) and
    `b[name]` (L, r, out); `alpha / rank` scales the product at merge."""

    def __init__(self, a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor],
                 rank: int = 8, alpha: float = 16.0):
        super().__init__()
        self.a = nn.ParameterDict({k: nn.Parameter(v) for k, v in a.items()})
        self.b = nn.ParameterDict({k: nn.Parameter(v) for k, v in b.items()})
        self.rank = rank
        self.alpha = alpha


def _target_weight(xformer: SmilesTransformer, name: str, layer: int) -> torch.Tensor:
    return xformer.transformer.h[layer].get_submodule(TARGETS[name]).weight


def init_lora(
    generator: torch.Generator,
    xformer: SmilesTransformer,
    rank: int = 8,
    alpha: float = 16.0,
    targets: Tuple[str, ...] = ("w_attn", "w_proj", "w_fc", "w_out"),
) -> LoraParams:
    """A ~ N(0, 1/in) drawn from `generator` (on its device, then placed
    with the trunk), B = 0: the adapter starts as an exact no-op, the
    merged trunk equal to the base."""
    a, b = {}, {}
    layers = len(xformer.transformer.h)
    for name in targets:
        if name not in TARGETS:
            raise ValueError(f"unknown LoRA target {name!r}; choose from {sorted(TARGETS)}")
        w = _target_weight(xformer, name, 0)
        n_out, n_in = w.shape
        draw = torch.randn((layers, n_in, rank), generator=generator, device=generator.device)
        a[name] = (draw / n_in**0.5).to(w.device)
        b[name] = torch.zeros((layers, rank, n_out), device=w.device)
    return LoraParams(a, b, rank=rank, alpha=alpha)


def _with_parameters(module: nn.Module, replaced: Dict[str, torch.Tensor],
                     prefix: str = "") -> nn.Module:
    """A structural copy of `module` (new objects of the same classes,
    buffers shared) whose parameters are the originals detached, except
    those named in `replaced`, which it holds instead."""
    out = copy.copy(module)  # a new object with a new __dict__, contents shared
    out.__dict__["_parameters"] = {
        name: replaced[prefix + name] if prefix + name in replaced
        else (None if p is None else p.detach())
        for name, p in module._parameters.items()
    }
    out.__dict__["_modules"] = {
        name: None if child is None else _with_parameters(child, replaced, prefix + name + ".")
        for name, child in module._modules.items()
    }
    return out


def merge_lora(xformer: SmilesTransformer, lora: LoraParams) -> SmilesTransformer:
    """The trunk with W + (alpha/r) A@B folded into each target weight, as
    a structural copy (see the module docstring); differentiable in the
    adapters only."""
    scale = lora.alpha / lora.rank
    merged = {}
    for name, a in lora.a.items():
        # (L, out, in): the (in, out) delta transposed into nn.Linear's layout
        delta = torch.einsum("lir,lro->loi", a, lora.b[name]) * scale
        for layer in range(delta.shape[0]):
            w = _target_weight(xformer, name, layer)
            merged[f"transformer.h.{layer}.{TARGETS[name]}.weight"] = (
                w.detach() + delta[layer].to(w.dtype))
    return _with_parameters(xformer, merged)


def merged_model(model: nn.Module, lora: LoraParams) -> nn.Module:
    """A structural copy of a model with a trunk at `.xformer` (CoatiModel,
    Coati2Model) whose trunk is merge_lora(model.xformer, lora): what
    `model_to_state` writes into a document and COATI(...) serves."""
    out = copy.copy(model)
    out.__dict__["_modules"] = dict(model._modules, xformer=merge_lora(model.xformer, lora))
    return out


def make_lora_ar_step(
    base_xformer: SmilesTransformer,
    cfg,
    optimizer: torch.optim.Optimizer,
    *,
    inject_token: Optional[int] = None,
):
    """A LoRA fine-tuning step on the AR objective:
    step(lora, tokens, y_next[, injection]) -> loss (a detached 0-d
    float32 tensor), after one update of `optimizer`, which holds the
    adapters' parameters (coati_tpu's optax.adam(lr) is
    torch.optim.Adam(lora.parameters(), lr)). The trunk is frozen:
    forward_logits runs on merge_lora(base_xformer, lora) in cfg's compute
    dtype, through the port's attention kernels on the card. Token arrays
    may be numpy or tensors; they go to the trunk's device."""
    device = next(base_xformer.parameters()).device

    def step(lora: LoraParams, tokens, y_next, injection=None) -> torch.Tensor:
        tokens = torch.as_tensor(tokens, dtype=torch.long, device=device)
        y_next = torch.as_tensor(y_next, dtype=torch.long, device=device)
        optimizer.zero_grad(set_to_none=True)
        logits = forward_logits(merge_lora(base_xformer, lora), cfg, tokens, injection,
                                inject_token)
        loss = ar_loss_fn(logits, y_next)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
