#!/usr/bin/env python3
"""Variants of the EGNN message kernels (K3, csrc/egnn_messages.cu; K4,
csrc/egnn_messages_bwd.cu), timed side by side on one CUDA card.

    python3 scripts/torch_egnn_variants.py [--out FILE] [--only k3,k4]
                                           [--csrc DIR] [--parent DIR]

from the repository root, on a machine with one CUDA card and nvcc. Built,
loaded and timed as scripts/torch_attention_variants.py does (its
build_variants and command line; --parent DIR times an older commit's
unpacked coati_tpu_torch/csrc beside these sources, in the same process).
K3 runs at the two shapes of the main paths, Hm 256, the bf16-product mode
(base and parent also float32): the 1,024 molecules of the points fixture
at the trained document's 5 A cutoff, and the first 160 at the grande
recipe's 12 A; K4 at the second, in the bf16-product and the float32
mode. Each result says whether it agrees with the plain version within
chip_smoke.py's tolerance (1e-3 or 1e-5 x max(1, max |plain|) of each
output); the ablations compute something else and are not expected to.

K3's variants (the tensor-core body):
  noproducts  each mma.sync replaced by one integer operation
  nosfu       the SiLUs without exponential or division (the SFU's work)
  noc         the rows of c not loaded (zeros in their place)

K4's variants, each with a set of edits for the source with the tensor-core
body and, where it applies, one for the older source with the CUDA-core
body only (W2 and a transposed W2 streamed in 16-deep tiles; the CUDA-core
body stays for float32):
  noflush     CUDA-core body: dW2 not added into device memory by its
              per-chunk atomics
  noproducts  the three Hm x Hm products taken out (CUDA cores: their FMA
              loops; tensor cores: each mma.sync replaced by one integer
              operation)
  nodc        the float32 atomic adds into dc left out
  noda        the adds into da's shared accumulators left out
  noexchange  no slices of e1 and dz2 read from the other blocks of the
              cluster, and block barriers for the cluster's
  noc         the rows of c of the chunk's partners not copied
  noexp       the SiLUs of z1 and z2 and their derivatives without
              exponential or division
  skeleton    all six of noproducts to noexp at once
  roundrobin  cluster q takes the work items q, q + Q, ... instead of a
              range of equal cost
  w8          8 warps a block at 64 columns instead of 16
  w2resident  older source: W2 and W2^T read from a shared tile that is
              never reloaded, so no streaming loads and no barriers around
              them (what a resident W2 would save)
"""

from __future__ import annotations

import ctypes
import sys

import torch

import torch_attention_variants as tv
from torch_attention_variants import MMA, NO_MMA, cs

from coati_tpu_torch.ops import egnn_messages as plain
from coati_tpu_torch.ops.kernels import egnn_messages as km

SRC = "egnn_messages_bwd.cu"
SRC3 = "egnn_messages.cu"
SILU3 = "__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.f + __expf(-x)); }"
C_LOADS3 = ("              const float4 c0 = __ldg(reinterpret_cast<const float4*>(crow));\n"
            "              const float4 c1 = __ldg(reinterpret_cast<const float4*>(crow) + 1);\n")
TC_SOURCE = '#include "mma.cuh"'  # only the tensor-core source includes the mma helpers
W2T_ARG = "const float* __restrict__ w2t,"  # only the older source takes W2^T
WARPS = "__host__ __device__ constexpr int tc_warps(int sw) { return sw == 64 ? 16 : 8; }"
EXCHANGE = "for (int it = 0; it < (kCluster - 1) * kBM * (SW / 8) / THREADS; ++it) {"
COPY_C = "        for (int it = 0; it < kBM * SW / 4 / THREADS; ++it) {"
BARRIERS = [
    (SRC, "      cluster.sync();  // every block's slice of e1 is written", "      __syncthreads();"),
    (SRC, "      cluster.sync();  // every block's slice of dz2 is written, e1 copies are done",
     "      __syncthreads();")]


def off(text):
    """the loop header `text` run no times"""
    return (SRC, text, text.replace("; ++it", " * (hm < 0); ++it"))


# the ablations of the kept body, one list of edits each
KEPT = {
    "noproducts": [(SRC, TC_SOURCE, TC_SOURCE), ("mma.cuh", MMA, NO_MMA)],
    "nodc": [(SRC, "if (run_j >= 0 && col_ok) atomicAdd(",
              "if (run_j >= 0 && col_ok && hm < 0) atomicAdd(")],
    "noda": [(SRC, "          dag[row_i[m] * SW] += v;", "          if (hm < 0) dag[row_i[m] * SW] += v;")],
    "noexchange": [*BARRIERS, off(EXCHANGE)],
    "noc": [off(COPY_C)],
    "noexp": [(SRC, "const float sg = 1.f / (1.f + expf(-z));", "const float sg = 0.5f + 0.125f * z;"),
              (SRC, "dsilu(acc[nt][2 * h + u] + b2_s[lc + u])", "(acc[nt][2 * h + u] + b2_s[lc + u])")],
}
# (source, label, [edits of the tensor-core source, of the older one])
VARIANTS = [
    ("egnn_messages_bwd", "base", [[]]),
    ("egnn_messages_bwd", "noflush", [
        [(SRC, "          const int k = k0 + m0 + r;\n          if (k >= hm) continue;",
          "          const int k = k0 + m0 + r;\n          if (k >= hm || hm > 0) continue;")],
    ]),
    ("egnn_messages_bwd", "noproducts", [
        KEPT["noproducts"],
        [(SRC, "    for (int kk = 0; kk < kBK; kk += 4) {",
          "    for (int kk = 0; kk < kBK * (hm < 0); kk += 4) {"),
         (SRC, "        for (int p = 0; p < kBM; ++p) {",
          "        for (int p = 0; p < kBM * (hm < 0); ++p) {")],
    ]),
    *(("egnn_messages_bwd", label, [KEPT[label]])
      for label in ("nodc", "noda", "noexchange", "noc", "noexp")),
    ("egnn_messages_bwd", "skeleton", [[e for edits in KEPT.values() for e in edits]]),
    ("egnn_messages_bwd", "roundrobin", [
        [(SRC, "  coati::item_range(cost, items, cl, n_clusters, &first, &end);\n"
               "  for (int item = first; item < end; ++item) {",
          "  for (int item = cl; item < items; item += n_clusters) {")],
        [(SRC, "  for (int item = first; item < items && start(item) < hi; ++item) {",
          "  for (int item = cl + 0 * first; item < items; item += n_clusters) {")],
    ]),
    ("egnn_messages_bwd", "w8", [
        [(SRC, WARPS, WARPS.replace("sw == 64 ? 16 : 8", "8"))],
    ]),
    ("egnn_messages_bwd", "w2resident", [
        [(SRC, W2T_ARG, W2T_ARG),
         (SRC, "    __syncthreads();  // the tile is free (and lhs is complete)\n"
               "    for (int e = tid; e < kBK * kBN; e += kThreads) {",
          "    if (k0 == 0) __syncthreads();  // the tile is free (and lhs is complete)\n"
          "    for (int e = tid; e < kBK * kBN && k0 < 0; e += kThreads) {"),
         (SRC, "    __syncthreads();\n#pragma unroll\n    for (int kk = 0; kk < kBK; kk += 4) {",
          "#pragma unroll\n    for (int kk = 0; kk < kBK; kk += 4) {")],
    ]),
]
VARIANTS += [
    ("egnn_messages", "base", [[]]),
    ("egnn_messages", "noproducts", [[(SRC3, TC_SOURCE, TC_SOURCE), ("mma.cuh", MMA, NO_MMA)]]),
    ("egnn_messages", "nosfu", [[(SRC3, SILU3, SILU3.replace(
        "__fdividef(x, 1.f + __expf(-x))", "x * (0.5f + 0.125f * x)"))]]),
    ("egnn_messages", "noc", [[(SRC3, C_LOADS3,
                                "              const float4 c0 = make_float4(0.f, 0.f, 0.f, j), "
                                "c1 = c0;\n")]]),
]
KERNELS = {"k3": "egnn_messages", "k4": "egnn_messages_bwd"}


def measure(libs, emit) -> None:
    measure_k3({k: v for k, v in libs.items() if k[0] == "egnn_messages"}, emit)
    measure_k4({k: v for k, v in libs.items() if k[0] == "egnn_messages_bwd"}, emit)


def measure_k3(libs, emit) -> None:
    """K3 at the points path's and the trainer's shapes; the entry point of
    the tensor-core source takes the costs' scratch and a counter after the
    output, the older one does not."""
    if not libs:
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = km.build.stream_handle(torch.device("cuda"))
    hm = 256
    for rows, cutoff in ((1024, 5.0), (160, 12.0)):
        d2, w, _ = cs._fixture_geometry(rows, cutoff)
        b, n, _ = d2.shape

        def rand(*shape, scale=1.0):
            return scale * torch.randn(*shape, generator=gen, device="cuda")

        a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
        wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
        w2 = rand(hm, hm, scale=hm**-0.5)
        ins = (a, c, d2, w, wd, b1, w2, b2)
        out = torch.empty_like(a)
        cost = torch.empty(km.fwd_work_split(b, n, hm)["scratch_int64"], dtype=torch.int64,
                           device="cuda")
        done = torch.zeros(1, dtype=torch.int32, device="cuda")
        for mm in (torch.bfloat16, torch.float32):
            ref = plain.egnn_messages(*ins, mm_dtype=mm)
            tol = (1e-3 if mm == torch.bfloat16 else 1e-5) * max(1.0, float(ref.abs().max()))
            row = {"kernel": "egnn_messages", "shape": [b, n, hm], "cutoff": cutoff,
                   "mm_dtype": str(mm)[6:], "live_pairs": int((w != 0).sum())}
            for (_, label), (lib, text) in libs.items():
                if mm == torch.float32 and label not in ("base", "parent"):
                    continue
                fn = lib.egnn_messages
                new = "void* cost, void* done" in text
                fn.argtypes = km._ARGTYPES if new else [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                if not new:
                    lib.egnn_messages_smem_bytes.argtypes = [ctypes.c_int] * 2
                extra = (cost.data_ptr(), done.data_ptr()) if new else ()

                def call(fn=fn, extra=extra, mm=mm):
                    if extra:
                        done.zero_()  # the costs kernel's counter starts at 0
                    return fn(*(x.data_ptr() for x in ins), out.data_ptr(), *extra, b, n, hm,
                              int(mm == torch.bfloat16), stream)

                row[label] = tv._timed(call, [out], [ref], [tol])
            emit(row)


def measure_k4(libs, emit) -> None:
    if not libs:
        return
    gen = torch.Generator(device="cuda").manual_seed(0)
    d2, w, _ = cs._fixture_geometry(160, 12.0)
    b, n, _ = d2.shape
    hm = 256

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
    wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
    w2 = rand(hm, hm, scale=hm**-0.5)
    g = rand(b, n, hm)
    w2t = w2.t().contiguous()
    stream = km.build.stream_handle(torch.device("cuda"))
    for mm in (torch.bfloat16, torch.float32):
        refs = plain.egnn_messages_backward(a, c, d2, w, wd, b1, w2, b2, g, mm_dtype=mm)
        rel = 1e-3 if mm == torch.bfloat16 else 1e-5
        tols = [rel * max(1.0, float(r.abs().max())) for r in refs]
        row = {"kernel": "egnn_messages_backward", "shape": [b, n, hm],
               "mm_dtype": str(mm)[6:], "live_pairs": int((w != 0).sum())}
        for (_, label), (lib, text) in libs.items():
            fn = lib.egnn_messages_bwd
            old = "const void* w2t" in text  # the older entry point takes W2^T too
            extra, done = (), None
            if old:
                fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            else:  # a scratch, counters and the clusters of the bf16 body
                fn.argtypes = km._BWD_ARGTYPES
                query = lib.egnn_messages_bwd_clusters
                query.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
                query.restype = ctypes.c_int
                floats = ctypes.c_longlong(0)
                clusters = query(b, n, hm, ctypes.byref(floats))
                row[f"{label}_clusters"] = clusters
                scratch = torch.empty(max(floats.value, 1), device="cuda")
                done = torch.zeros(km.BWD_CLUSTER + 1, dtype=torch.int32, device="cuda")
                extra = ((scratch.data_ptr(), done.data_ptr(), clusters)
                         if mm == torch.bfloat16 else (None, None, 0))
            fn.restype = ctypes.c_int
            ins = (a, c, d2, w, wd, b1, w2, w2t, b2, g) if old else (a, c, d2, w, wd, b1, w2, b2, g)
            outs = [torch.empty_like(a), torch.empty_like(c), *torch.empty(3, hm, device="cuda"),
                    torch.empty(hm, hm, device="cuda")]
            outs = [outs[0], outs[1], outs[2], outs[3], outs[5], outs[4]]  # da dc dwd db1 dw2 db2

            def call(fn=fn, ins=ins, outs=outs, extra=extra, done=done):
                for x in outs[1:]:
                    x.zero_()  # the kernel adds into dc (and the parameter gradients)
                if done is not None and extra[0] is not None:
                    done.zero_()  # the bf16 body's counters start at 0
                return fn(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs),
                          *extra, b, n, hm, int(mm == torch.bfloat16), stream)

            row[label] = tv._timed(call, outs, refs, tols)
        emit(row)


if __name__ == "__main__":
    sys.exit(tv.run(__doc__.splitlines()[0], VARIANTS, KERNELS, measure))
