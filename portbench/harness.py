"""What every cell's run shares: spans on the host clock, the card's
clock and memory, the profiler trace read into busy time, launches and the
breakdown, the per-layer metric readers found by name, and the check for
the JAX package in the process."""

from __future__ import annotations

import bisect
import importlib.util
import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "coati_tpu")
# device operations that are copies or fills, not kernel launches
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def now() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Seconds spent in named host spans, summed while `on`."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.on = False

    @contextmanager
    def __call__(self, name: str):
        start = now()
        try:
            yield
        finally:
            if self.on:
                self.seconds[name] += now() - start


def forbidden_modules() -> list:
    """Modules of the JAX package or JAX itself loaded in this process,
    compared by whole top-level name."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def load_file(path: Path, name: str):
    """A module of the benchmark found by its file name (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    return load_file(BENCH_DIR / "metrics" / f"{name}.py", name).read


def driver(name: str):
    return load_file(BENCH_DIR / "drivers" / f"{name}.py", name)


def device_info(device, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# ----------------------------------------------------------------- trace


def _events(prof):
    """(device ops, host ops) of a finished profile as (name, start_s,
    end_s) lists: device ops are the card's kernels, copies and fills, host
    ops the CPU side's operator calls."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        item = (e.name(), start, start + e.duration_ns() / 1e9)
        if e.device_type() == DeviceType.CUDA:
            # a range's shadow on the device timeline (the optimizer's step
            # is one) spans kernels and the gaps between them: no operation
            if not (e.is_user_annotation() or e.name().startswith("Optimizer.")):
                device.append(item)
        elif e.device_type() == DeviceType.CPU and not e.name().startswith("cuda"):
            host.append(item)
    return device, host


def union_seconds(intervals) -> float:
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def _gaps(device, host):
    """Idle stretches of the card, each named by the host operation that
    had started last when the card went idle."""
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    end = None
    for _, s, e in sorted(device, key=lambda x: x[1]):
        if end is not None and s > end:
            i = bisect.bisect_right(starts, end) - 1
            gaps[host[i][0] if i >= 0 else "host"] += s - end
        end = e if end is None else max(end, e)
    return gaps


class Trace:
    """A profiled stretch of work: what the card ran, and when."""

    def __init__(self, device_ops, host_ops):
        self.device_ops = device_ops
        self.host_ops = sorted(host_ops, key=lambda x: x[1])
        self.busy_s = union_seconds(device_ops)
        self.launches = sum(1 for n, _, _ in device_ops if not n.startswith(NOT_KERNELS))

    def kernel_seconds(self, pattern: str) -> float:
        """Device seconds of the kernels whose name holds `pattern`."""
        return sum(e - s for n, s, e in self.device_ops if pattern in n)

    def breakdown(self, top: int = 10) -> dict:
        by_name = defaultdict(float)
        for n, s, e in self.device_ops:
            by_name[n[:120]] += e - s
        gaps = _gaps(self.device_ops, self.host_ops)

        def head(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": head(by_name), "idle_gaps": head(gaps)}


class ManualProfile:
    """A profile on the card, started and stopped by the caller, also from
    inside a loop the benchmark does not own (the trainer's):
    `start()`, `stop()` -> Trace."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self):
        sync(self.device)
        self.prof.start()

    def stop(self) -> Trace:
        sync(self.device)
        self.prof.stop()
        return Trace(*_events(self.prof))


@contextmanager
def profiled(device):
    """Profile the body on the card: yields a list that holds the Trace
    once the body is done."""
    out, profile = [], ManualProfile(device)
    profile.start()
    yield out
    out.append(profile.stop())
