"""Elementary neural-net ops shared across models.

Plain functions on tensors, numerics of coati_tpu/ops/layers.py: LayerNorm
with eps 1e-5 and statistics in float32, tanh-approximated GELU. Linear
weights use PyTorch's (out_features, in_features) layout.
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
    pay nothing on the hot path."""
    if not any(p.dtype == torch.float32 and p.dtype != dtype for p in module.parameters()):
        return module
    out = copy.deepcopy(module)
    for p in out.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return out


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis, stats and affine in float32."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), LN_EPS)
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximated GELU (GPT-style 'NewGELU')."""
    return F.gelu(x, approximate="tanh")


def linear(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """x @ w.T (+ b); w is stored (out_features, in_features)."""
    return F.linear(x, w, b)
