"""Precision of the reference's products.

`EXACT` leaves every operand in float32. `LowPrecision` is the control: the
reference computed one step below what a configuration states. For a
bfloat16 configuration that is float8 (e4m3): each matrix product's weight
(one scale a tensor) and input (one scale a row), and each activation the
model carries from layer to layer (the trunk's residual stream, the point
encoder's atom states; one scale a row), with the gradient passed straight
through. With `kv_bits` 4 it also rounds attention's keys and values to
int4 with one scale per (token, head), one step below an int8 cache.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3


def _fp8(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    scale = amax.clamp_min(1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach()


class Exact:
    """float32 throughout."""

    def w(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def kv(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def store(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as a layer hands it to the next."""
        return x


class LowPrecision(Exact):
    """float8 weights, inputs of every product and carried activations;
    optionally int4 K and V."""

    def __init__(self, kv_bits=None):
        self.kv_bits = kv_bits

    def w(self, x):
        return _fp8(x, x.detach().abs().amax())

    def act(self, x):
        return _fp8(x, x.detach().abs().amax(dim=-1, keepdim=True))

    store = act

    def kv(self, x):  # (B, T, H, Dh)
        if self.kv_bits is None:
            return x
        top = 2 ** (self.kv_bits - 1) - 1
        scale = x.detach().abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / top
        q = torch.clamp(torch.round(x / scale), -top, top) * scale
        return x + (q - x).detach()


EXACT = Exact()


def matmul(x: torch.Tensor, w: torch.Tensor, b, q: Exact) -> torch.Tensor:
    """x @ w (+ b), w in (in, out) layout, under precision q."""
    y = q.act(x) @ q.w(w)
    return y if b is None else y + b
