"""Build and load the port's CUDA kernels (coati_tpu_torch/csrc/*.cu).

Each source compiles with nvcc, on its own, into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), which
ctypes loads. Builds happen at first use, never at import, and are keyed
on a hash of the source, the shared headers and the flags: an edited
source rebuilds, an unchanged one loads from coati_tpu_torch/_build/
(listed in .gitignore). `build()` compiles several sources in parallel,
one nvcc process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = (
    "flash_attention", "decode_attention", "egnn_messages", "packed_attention",
    "egnn_messages_bwd", "packed_attention_bwd",
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
