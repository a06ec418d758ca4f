"""Elementary neural-net ops shared across models.

Plain functions on tensors, numerics of coati_tpu/ops/layers.py: LayerNorm
and instance norm with eps 1e-5 and statistics in float32, tanh-approximated
GELU. Linear weights use PyTorch's (out_features, in_features) layout.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def cast_floats(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The module with its float32 parameters cast to the compute dtype
    (fp32 master weights, low-precision compute). Returns the module
    itself when nothing needs casting, so callers that cast once up front
    pay nothing on the hot path.

    The cast is one autograd follows: the result is a structural copy of
    the module (same classes, same child names, so indexing, iteration and
    isinstance checks work as on the original) that holds, in place of each
    parameter, the tensor `p.to(dtype)`. A loss computed through the copy
    leaves its gradient, in float32, on the master parameters. The copy
    registers no parameters of its own."""
    if dtype == torch.float32 or not any(
        p.dtype == torch.float32 for p in module.parameters()
    ):
        return module
    return _cast_copy(module, dtype)


def _cast_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    out = copy.copy(module)  # a new object with a new __dict__, contents shared
    out.__dict__["_parameters"] = {}
    out.__dict__["_modules"] = {
        name: None if child is None else _cast_copy(child, dtype)
        for name, child in module._modules.items()
    }
    for name, p in module._parameters.items():
        out.__dict__[name] = p.to(dtype) if p is not None and p.dtype == torch.float32 else p
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, stats and affine in float32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), LN_EPS)
    return y.to(x.dtype)


def instance_norm_lastdim(x: torch.Tensor) -> torch.Tensor:
    """Affine-free normalization over the last axis, stats in float32 with
    the biased variance (how the reference applies torch InstanceNorm1d to
    (B, atoms, hidden) tensors: per (batch, atom) over the hidden dim)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + LN_EPS)).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (GPT-style 'NewGELU')."""
    return F.gelu(x, approximate="tanh")


def linear(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x @ w.T (+ b); w is stored (out_features, in_features)."""
    return F.linear(x, w, b)
