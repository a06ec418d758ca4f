"""Small host-side utilities."""

from __future__ import annotations

import torch


def colored_background(r: int, g: int, b: int, text: str) -> str:
    """ANSI 24-bit background color wrapper (r, g, b in [0, 255])."""
    return f"\033[48;2;{r};{g};{b}m{text}\033[0m"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another (the tests pass "cpu"). Without a card and without an
    explicit device this raises; it never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: coati_tpu_torch runs on the GPU; pass device='cpu' "
                "to run on the CPU explicitly"
            )
        device = "cuda"
    return torch.device(device)
