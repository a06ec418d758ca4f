#!/usr/bin/env python3
"""Variants of the port's bf16 attention kernels (K2, csrc/flash_attention.cu;
K5f, csrc/packed_attention.cu), timed side by side on one CUDA card.

    python3 scripts/torch_attention_variants.py [--out FILE]

from the repository root, on a machine with one CUDA card and nvcc. Each
variant is a copy of a kernel's source and of the shared headers with some
text replaced, built with the flags of ops/kernels/build.py into a scratch
directory, loaded with ctypes and called through the same C entry point as
the library it copies; `base` replaces nothing. Times come from
chip_smoke.time_ms (median of 25 launches, L2 flushed before each), all in
one process, on the main paths' shapes (bf16, H 16, Dh 16). Each result
says whether it agrees with the plain version within chip_smoke.py's bf16
tolerance: the ablations compute something else and are not expected to.

The variants:
  K2  lb6, lb8    __launch_bounds__ asking for 6 or 8 blocks an SM
      noexp       the probabilities' exponential replaced by its argument
      noarith     no arithmetic: the loads, barriers and stores alone
      l2_256      the 16-byte copies with a 256-byte L2 prefetch hint
  K5f lb5         __launch_bounds__ asking for 5 blocks an SM
      noexp       as for K2
      gN          every head group N that fits in 48 KB, for `base`
Every line of output is one JSON object: first the card, then the
registers and spills of each variant, then one line a shape.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from coati_tpu_torch.ops.attention import causal_attention  # noqa: E402
from coati_tpu_torch.ops.kernels import build  # noqa: E402
from coati_tpu_torch.ops.kernels import flash_attention as kf  # noqa: E402
from coati_tpu_torch.ops.kernels import packed_attention as kp  # noqa: E402

K2_BOUNDS = "__launch_bounds__(kThreads) flash_causal_bf16_kernel"
K5F_BOUNDS = "__launch_bounds__(kTcThreads) packed_causal_bf16_kernel"
COPY = "cp.async.cg.shared.global [%0], [%1], 16, %2;"

# (source, label, [(file, text, replacement), ...])
VARIANTS = [
    ("flash_attention", "base", []),
    ("flash_attention", "lb6", [("flash_attention.cu", K2_BOUNDS,
                                 K2_BOUNDS.replace("kThreads)", "kThreads, 6)"))]),
    ("flash_attention", "lb8", [("flash_attention.cu", K2_BOUNDS,
                                 K2_BOUNDS.replace("kThreads)", "kThreads, 8)"))]),
    ("flash_attention", "noexp", [("flash_attention.cu", "p[u][e] = coati::exp2_fast(",
                                   "p[u][e] = (")]),
    ("flash_attention", "noarith", [("flash_attention.cu",
                                     "    if (live) {\n      if (j == 0) {",
                                     "    if (live && seq < 0) {\n      if (j == 0) {")]),
    ("flash_attention", "l2_256", [("mma.cuh", COPY, COPY.replace("global [", "global.L2::256B ["))]),
    ("packed_attention", "base", []),
    ("packed_attention", "lb5", [("packed_attention.cu", K5F_BOUNDS,
                                  K5F_BOUNDS.replace("kTcThreads)", "kTcThreads, 5)"))]),
    ("packed_attention", "noexp", [("packed_attention.cu", "s[n][e] = coati::exp2_fast(",
                                    "s[n][e] = (")]),
]
K2_SHAPES = ((1024, 250), (1024, 128), (1024, 96), (1024, 3))
K5F_SHAPES = ((1024, 96), (1024, 128), (160, 32), (160, 48), (160, 80), (1024, 3))
H, DH = 16, 16


def build_variants(workdir: Path):
    """Compile every variant, all at once; returns {(source, label): its C
    entry point} and {(source, label): ptxas usage of its bf16 kernels}."""
    jobs = []
    for source, label, edits in VARIANTS:
        src = workdir / f"{source}_{label}"
        src.mkdir()
        files = {f: (build.CSRC_DIR / f).read_text() for f in (f"{source}.cu", *build.HEADERS)}
        for name, text, replacement in edits:
            if text not in files[name]:
                raise RuntimeError(f"{source}/{label}: {text!r} not in {name}")
            files[name] = files[name].replace(text, replacement)
        for name, text in files.items():
            (src / name).write_text(text)
        lib = src / f"lib{source}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src / f"{source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, label, lib, proc))
    libs, usage = {}, {}
    for source, label, lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}/{label}:\n{log}")
        usage[(source, label)] = {k: u for k, u in cs.ptxas_usage(log).items() if "bf16" in k}
        k2 = source == "flash_attention"
        fn = getattr(ctypes.CDLL(str(lib)), "flash_causal_attention" if k2 else
                     "packed_causal_attention")
        fn.argtypes = kf._ARGTYPES if k2 else kp._ARGTYPES
        fn.restype = ctypes.c_int
        libs[(source, label)] = fn
    return libs, usage


def _inputs(gen, b, t):
    qkv = torch.randn(b, t, 3 * H * DH, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (x.view(b, t, H, DH) for x in qkv.split(H * DH, dim=-1))
    out = torch.empty(b, t, H, DH, dtype=torch.bfloat16, device="cuda")
    ref = causal_attention(q, k, v, torch.float32).float()
    return q, k, v, out, ref, 2 * cs.BF16_ULP * float(ref.abs().max())


def _timed(run, out, ref, tol):
    """[ms, agrees with the plain version]"""
    err = run()
    if err != 0:
        raise RuntimeError(f"CUDA error {err}")
    torch.cuda.synchronize()
    agrees = float((out.float() - ref).abs().max()) <= tol
    return [cs.time_ms(run), agrees]


def measure(libs, emit) -> None:
    stream = build.stream_handle(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(DH)
    bf16 = build.DTYPE_CODES[torch.bfloat16]

    for b, t in K2_SHAPES:
        q, k, v, out, ref, tol = _inputs(gen, b, t)
        row = {"kernel": "flash_causal_attention", "shape": [b, t, H, DH]}
        for (source, label), fn in libs.items():
            if source == "flash_attention":
                row[label] = _timed(lambda: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, H, DH, bf16,
                    q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), scale, stream), out, ref, tol)
        emit(row)

    for b, t in K5F_SHAPES:
        q, k, v, out, ref, tol = _inputs(gen, b, t)
        rule = kp.head_group(t, H, DH, torch.bfloat16)
        row = {"kernel": "packed_causal_attention", "shape": [b, t, H, DH], "rule_group": rule}
        for (source, label), fn in libs.items():
            if source != "packed_attention":
                continue
            groups = [g for g in (1, 2, 4, 8, 16)
                      if g * kp.staged_bytes(t, DH, torch.bfloat16) <= 48 * 1024]
            for g in groups if label == "base" else [rule]:
                row[f"{label}_g{g}"] = _timed(lambda: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, H, DH, g,
                    bf16, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), scale, stream), out, ref, tol)
        emit(row)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also append every JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_attention_variants: no CUDA device", file=sys.stderr)
        return 2
    log = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "sm_clock_mhz": cs.sm_clock_hz() / 1e6})
    with tempfile.TemporaryDirectory() as tmp:
        libs, usage = build_variants(Path(tmp))
        for (source, label), u in usage.items():
            emit({"variant": f"{source}/{label}", "ptxas": u})
        measure(libs, emit)
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
