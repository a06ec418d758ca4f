"""Build and load the port's CUDA kernels (coati_tpu_torch/csrc/*.cu).

Each source compiles with nvcc, on its own, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), which
ctypes loads. Builds happen at first use, never at import, and are keyed
on a hash of the source, the shared headers and the flags: an edited
source rebuilds, an unchanged one loads from coati_tpu_torch/_build/
(listed in .gitignore). `build()` compiles several sources in parallel,
one nvcc process each.

Each kernel wrapper counts its launches in a counter attribute of its own
(`.launches`, and `.bwd_launches` for a backward kernel) through
`count_launch`. A launch made while the current stream is being captured
into a CUDA graph runs nothing on the card then: it is counted in the
recording of `recording_launches` for that stream instead, whichever
thread makes it (autograd launches a backward from a thread of its own, on
its forward's stream), and nowhere outside one; the graph's owner adds
those counts at each replay (`add_launches`), so the counters count what
runs on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (
    "flash_attention", "decode_attention", "egnn_messages", "packed_attention",
    "egnn_messages_bwd", "packed_attention_bwd", "mla_decode", "top_k",
)
HEADERS = ("common.cuh", "mma.cuh", "egnn_items.cuh")  # every header a source includes: hashed into each library
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into BUILD_LOG
)

# element-type codes of the C entry points (csrc/common.cuh, coati::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

# nvcc's output of the build of each source that was built or loaded
# (ptxas resource usage), also kept beside each library as <library>.log
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# one build at a time within a process: threads that call a kernel for the
# first time together (a server's batchers) would share a temporary file
_LOAD_LOCK = threading.Lock()
# capturing stream -> {(wrapper, counter): launches} of the graph captured on it
_RECORDINGS: Dict[int, dict] = {}
_RECORDING_LOCK = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC_DIR} where the CUDA toolkit is installed"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for part in (f"{name}.cu", *HEADERS):
        digest.update((CSRC_DIR / part).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile the named sources that have no up-to-date library, all in
    parallel. Returns the wall seconds spent; raises on a failed build."""
    start = time.perf_counter()
    jobs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            log = target.with_suffix(".log")
            BUILD_LOG[name] = log.read_text() if log.exists() else ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, target, tmp, proc))
    failures = []
    for name, target, tmp, proc in jobs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        target.with_suffix(".log").write_text(out)
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build((name,))
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (its launch was
    refused or its arguments rejected)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _stream_key() -> int:
    return torch.cuda.current_stream().cuda_stream


@contextlib.contextmanager
def recording_launches():
    """Yields a dict that counts, by (wrapper, counter name), the launches
    onto the current stream that a CUDA graph captured inside the block
    records; they go to it and not to the counters, since a capture runs
    nothing and each replay runs them all."""
    key = _stream_key()
    counts: dict = {}
    with _RECORDING_LOCK:
        saved = _RECORDINGS.get(key)
        _RECORDINGS[key] = counts
    try:
        yield counts
    finally:
        with _RECORDING_LOCK:
            if saved is None:
                _RECORDINGS.pop(key, None)
            else:
                _RECORDINGS[key] = saved


def count_launch(wrapper, counter: str = "launches") -> None:
    """One launch of `wrapper`: in its counter `counter`, or, while the
    current stream is being captured, in the capture's recording (if any)."""
    if torch.cuda.is_current_stream_capturing():
        counts = _RECORDINGS.get(_stream_key())
        if counts is not None:
            counts[wrapper, counter] = counts.get((wrapper, counter), 0) + 1
        return
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def add_launches(recorded: dict) -> None:
    """Add a recording's launches to their counters: one replay's."""
    for (wrapper, counter), n in recorded.items():
        setattr(wrapper, counter, getattr(wrapper, counter) + n)
