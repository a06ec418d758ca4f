"""Step timing and a numerical guard for the trainer.

Counterpart of coati_tpu/training/diagnostics.py: `step_timer` (per-step
wall-clock accounting for the JSONL logger) and `finite_check` (NaN/Inf
audit of parameters or any mapping of tensors). The JAX package's
profile_trace, compiled_cost and checkify_nan_guard are JAX tooling; their
PyTorch equivalents (torch.profiler, torch.autograd.set_detect_anomaly) are
not wrapped here yet.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn


class step_timer:
    """Accumulates step wall-clock stats; emit() -> metrics dict. The
    caller decides what a step's end is: work queued on a CUDA stream is
    not waited for."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def emit(self) -> Dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_sec": float(1.0 / arr.mean()),
        }


def _named_tensors(
    tree: Union[nn.Module, Mapping[str, torch.Tensor]]
) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(tree, nn.Module):
        yield from tree.named_parameters()
        yield from tree.named_buffers()
    else:
        yield from tree.items()


def finite_check(tree: Union[nn.Module, Mapping[str, torch.Tensor]], name: str = "tree") -> None:
    """NaN/Inf audit of a module's parameters and buffers, or of a mapping
    of tensors; raises with the names of the bad entries. Reads every
    tensor back to the host."""
    bad = [
        key for key, x in _named_tensors(tree)
        if isinstance(x, torch.Tensor) and x.is_floating_point()
        and not bool(torch.isfinite(x).all())
    ]
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")
