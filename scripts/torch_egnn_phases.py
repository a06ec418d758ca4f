#!/usr/bin/env python3
"""Where the time of K3's bf16-product body goes (csrc/egnn_messages.cu), by
clock64 probes in a copy of the source, on one CUDA card.

    python3 scripts/torch_egnn_phases.py [--csrc DIR] [--out FILE]

from the repository root, on a machine with one CUDA card and nvcc. The
copy adds, for thread 0 of each block, running totals of the clocks spent
in each phase of a work item: empty items (no live pair), listing (the
item's w and a rows, the counts and the pair list), the first chunk's e1
tile, and per chunk the products, the epilogue, the next chunk's e1 tile and
the wait at the chunk's barrier; then the combine of the ranges' sums. It
runs at the points path's shape (the 1,024 molecules of the points fixture,
the trained document's 5 A cutoff) and the trainer's (the first 160 at the
grande recipe's 12 A), Hm 256, and prints the mean and the largest total
over the blocks, with the chunks and items a block took, the whole kernel's
clocks and its time (chip_smoke.time_ms; the probes cost a little). Thread
0 waits at every block barrier, so a phase's clocks include the slowest
warp's share of it. --csrc takes the source from another directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from coati_tpu_torch.ops.kernels import build  # noqa: E402
from coati_tpu_torch.ops.kernels import egnn_messages as km  # noqa: E402

PHASES = ["empty_items", "listing", "first_tile", "products", "epilogue", "next_tile",
          "barrier", "combine", "chunks", "items"]
SLOTS = 16  # longs a block in the probes' buffer
MAX_BLOCKS = 1024

# (text of the source, its replacement): the probes
PROBES = [
    ("    float* ob = out + tile_at * hm;\n    if (cost[item]",
     "    float* ob = out + tile_at * hm;\n    T0 = clock64();\n    if (cost[item]"),
    ("      for (int e = tid; e < rows * hm; e += THREADS) ob[e] = 0.f;\n      continue;",
     "      for (int e = tid; e < rows * hm; e += THREADS) ob[e] = 0.f;\n"
     "      PH[0] += clock64() - T0;\n      continue;"),
    ("    int total = 0;\n#pragma unroll\n    for (int q = 0; q < kTileI; ++q) total += cnt[q];",
     "    PH[1] += clock64() - T0;\n    T0 = clock64();\n    int total = 0;\n"
     "#pragma unroll\n    for (int q = 0; q < kTileI; ++q) total += cnt[q];"),
    ("    build(0, 0);\n    __syncthreads();\n",
     "    build(0, 0);\n    __syncthreads();\n    PH[2] += clock64() - T0;\n    T0 = clock64();\n"
     "    PH[9] += 1;\n"),
    ("      // m = w silu(z2 + b2), summed over the range's pairs in list order:",
     "      PH[3] += clock64() - T0;\n      T0 = clock64();\n      PH[8] += 1;\n"
     "      // m = w silu(z2 + b2), summed over the range's pairs in list order:"),
    ("      if (chunk + 1 < chunks) build(chunk + 1, buf ^ 1);\n      __syncthreads();",
     "      PH[4] += clock64() - T0;\n      T0 = clock64();\n"
     "      if (chunk + 1 < chunks) build(chunk + 1, buf ^ 1);\n"
     "      PH[5] += clock64() - T0;\n      T0 = clock64();\n      __syncthreads();\n"
     "      PH[6] += clock64() - T0;\n      T0 = clock64();"),
    ("      if (any || cnt[il] == 0) ob[e] = sum;\n    }\n  }\n}",
     "      if (any || cnt[il] == 0) ob[e] = sum;\n    }\n    PH[7] += clock64() - T0;\n  }\n"
     f"  if (tid == 0 && blockIdx.x < {MAX_BLOCKS}) {{\n"
     f"    for (int q = 0; q < 10; ++q) probes[blockIdx.x * {SLOTS} + q] = PH[q];\n"
     f"    probes[blockIdx.x * {SLOTS} + 10] = clock64() - TK;\n  }}\n}}"),
    ("    const long long* __restrict__ cost, int batch, int n, int hm) {\n"
     "  constexpr int W = tc_warps(HP);",
     "    const long long* __restrict__ cost, int batch, int n, int hm) {\n"
     "  long long TK = clock64(), T0 = 0, PH[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  constexpr int W = tc_warps(HP);"),
    ("// SiLU on the special-function units: an exponential and a reciprocal",
     f"__device__ long long probes[{MAX_BLOCKS} * {SLOTS}];\n\n"
     "// SiLU on the special-function units: an exponential and a reciprocal"),
    ('extern "C" long long egnn_messages_smem_bytes(',
     'extern "C" int egnn_messages_probes(void* dst) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(dst, probes, sizeof(probes)));\n}\n\n"
     'extern "C" long long egnn_messages_smem_bytes('),
]


def build_probed(csrc: Path, workdir: Path) -> ctypes.CDLL:
    text = (csrc / "egnn_messages.cu").read_text()
    for old, new in PROBES:
        if old not in text:
            raise RuntimeError(f"the source has changed; probe not placed at:\n{old}")
        text = text.replace(old, new)
    for header in build.HEADERS:
        (workdir / header).write_text((csrc / header).read_text())
    (workdir / "egnn_messages.cu").write_text(text)
    lib_path = workdir / "libprobed.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib_path),
                           str(workdir / "egnn_messages.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(json.dumps({"ptxas": cs.ptxas_usage(proc.stdout + proc.stderr)}), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.egnn_messages.argtypes = km._ARGTYPES
    lib.egnn_messages.restype = ctypes.c_int
    lib.egnn_messages_probes.argtypes = [ctypes.c_void_p]
    lib.egnn_messages_probes.restype = ctypes.c_int
    return lib


def measure(lib, emit) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = build.stream_handle(torch.device("cuda"))
    hm = 256
    for rows, cutoff in ((1024, 5.0), (160, 12.0)):
        d2, w, _ = cs._fixture_geometry(rows, cutoff)
        b, n, _ = d2.shape

        def rand(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device="cuda")

        a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
        wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
        w2 = rand(hm, hm, scale=hm**-0.5)
        out = torch.empty_like(a)
        cost = torch.empty(km.fwd_work_split(b, n, hm)["scratch_int64"], dtype=torch.int64,
                           device="cuda")
        done = torch.zeros(1, dtype=torch.int32, device="cuda")

        def call():
            done.zero_()
            return lib.egnn_messages(*(x.data_ptr() for x in (a, c, d2, w, wd, b1, w2, b2)),
                                     out.data_ptr(), cost.data_ptr(), done.data_ptr(), b, n, hm,
                                     1, stream)

        if call() != 0:
            raise RuntimeError("launch failed")
        ms = cs.time_ms(call)
        probes = torch.zeros(MAX_BLOCKS * SLOTS, dtype=torch.int64, device="cuda")
        torch.cuda.synchronize()
        if lib.egnn_messages_probes(probes.data_ptr()) != 0:
            raise RuntimeError("reading the probes failed")
        totals = probes.view(MAX_BLOCKS, SLOTS)[:, :11].cpu().double()
        totals = totals[totals[:, 10] > 0]  # the blocks of the last launch
        names = PHASES + ["kernel"]
        emit({"shape": [b, n, hm], "cutoff": cutoff, "live_pairs": int((w != 0).sum()),
              "ms": ms, "blocks": len(totals),
              "mean_clocks": {k: float(x) for k, x in zip(names, totals.mean(0))},
              "max_clocks": {k: float(x) for k, x in zip(names, totals.max(0).values)}})


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--csrc", default=str(build.CSRC_DIR))
    parser.add_argument("--out", help="also append every JSON line to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_egnn_phases.py: no CUDA device", file=sys.stderr)
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
        measure(build_probed(Path(args.csrc), Path(tmp)), emit)
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
