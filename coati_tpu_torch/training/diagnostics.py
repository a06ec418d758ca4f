"""Tracing, timing and numerical guards for the trainer.

Counterpart of coati_tpu/training/diagnostics.py, on PyTorch's tools:

  * `profile_trace(logdir)`: torch.profiler over the block (the card's
    activity too when there is a card), a Chrome / TensorBoard trace
    written into `logdir`;
  * `step_timer`: per-step wall-clock accounting for the JSONL logger;
  * `compiled_cost(fn, *args)`: the FLOPs of one call of fn, counted by
    torch.utils.flop_counter (PyTorch runs eagerly: there is no compiled
    program whose cost model would also give the bytes accessed, so those
    are NaN, as coati_tpu reports when its backend gives none);
  * `finite_check` / `checkify_nan_guard`: NaN/Inf audits of parameters or
    of a function's outputs.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch
from torch import nn


@contextmanager
def profile_trace(logdir: str):
    """Trace the block with torch.profiler (CPU, and CUDA when a card is
    present) and write the trace into `logdir` as a
    `*.pt.trace.json` file that TensorBoard and Perfetto read."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


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


def compiled_cost(fn: Callable, *args):
    """(fn, {"flops", "bytes_accessed"}): the floating-point operations of
    one call fn(*args), which this runs, as torch.utils.flop_counter counts
    them (matrix products, convolutions and attention; 2 per multiply-add),
    and NaN bytes. The callable comes back unchanged, so that a caller
    written for coati_tpu's (compiled, cost) pair runs as it did."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return fn, {"flops": float(counter.get_total_flops()), "bytes_accessed": float("nan")}


def _floating_outputs(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() or tree.is_complex():
            yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _floating_outputs(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _floating_outputs(v)


def checkify_nan_guard(fn: Callable) -> Callable:
    """Wrap fn so that a call raises FloatingPointError when a floating
    tensor among its outputs (nested in tuples, lists and dicts) holds a
    NaN or an infinity. Each call reads one flag back from the device."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [i for i, x in enumerate(_floating_outputs(out)) if not bool(torch.isfinite(x).all())]
        if bad:
            raise FloatingPointError(f"{getattr(fn, '__name__', 'fn')}: non-finite values in "
                                     f"floating outputs {bad}")
        return out

    return wrapped
