#!/usr/bin/env python3
"""Variants of the port's attention kernels (K2, csrc/flash_attention.cu;
K5f, csrc/packed_attention.cu; K5b, csrc/packed_attention_bwd.cu), timed
side by side on one CUDA card.

    python3 scripts/torch_attention_variants.py [--out FILE] [--only k5b,...]
                                                [--csrc DIR] [--parent DIR]

from the repository root, on a machine with one CUDA card and nvcc. Each
variant is a copy of a kernel's source and of the shared headers with some
text replaced, built with the flags of ops/kernels/build.py into a scratch
directory, loaded with ctypes and called through the same C entry point as
the library it copies; `base` replaces nothing. --csrc takes the sources
from another directory (an unpacked older commit's coati_tpu_torch/csrc),
so that one script measures both, and --parent builds each chosen source
as it stands in another directory beside them (label `parent`), so that
one run times an older commit's kernel and this one's. A variant lists
one set of edits for each version of a source it knows, and the first set
whose every text is found applies (a variant with none is reported as
skipped). Times come
from chip_smoke.time_ms (median of 25 launches, L2 flushed before each),
all in one process, on the main paths' shapes (bf16, H 16, Dh 16). Each
result says whether it agrees with the plain version within
chip_smoke.py's bf16 tolerance: the ablations compute something else and
are not expected to.

The variants:
  K2  lb6, lb8    __launch_bounds__ asking for 6 or 8 blocks an SM
      noexp       the probabilities' exponential replaced by its argument
      noarith     no arithmetic: the loads, barriers and stores alone
      l2_256      the 16-byte copies with a 256-byte L2 prefetch hint
  K5f lb5         __launch_bounds__ asking for 5 blocks an SM
      noexp       as for K2
      gN          every head group N that fits in 48 KB, for `base`
  K5b noproducts  the five products taken out (staging, softmax, the
                  stashed P and dS and the stores stay)
      nophase2    phase 2 (dk and dv from the stashed P and dS) taken out
      stage_only  only the staging of q, k, v and g: no phase 1 or 2
      gN          every head group N of the bwd_head_group rule's budget,
                  for `base` (sources that take a group)
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
from coati_tpu_torch.ops.attention import causal_attention, causal_attention_backward  # noqa: E402
from coati_tpu_torch.ops.kernels import build  # noqa: E402
from coati_tpu_torch.ops.kernels import flash_attention as kf  # noqa: E402
from coati_tpu_torch.ops.kernels import packed_attention as kp  # noqa: E402

K2_BOUNDS = "__launch_bounds__(kThreads) flash_causal_bf16_kernel"
K5F_BOUNDS = "__launch_bounds__(kTcThreads) packed_causal_bf16_kernel"
COPY = "cp.async.cg.shared.global [%0], [%1], 16, %2;"
MMA = ('  asm volatile(\n      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
       '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n'
       '      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])\n'
       '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));\n')
# the product replaced by one integer operation on the same registers, so
# that the loads that feed it stay
NO_MMA = "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 ^ b1) & 1u);\n"
# markers of K5b's tensor-core body: the include of the mma helpers,
# and the comments that open its two phases, each before one statement
TC_BWD = '#include "mma.cuh"'
TC_PHASE1 = "  // phase 1 (tensor cores): "
TC_PHASE2 = "  // phase 2 (tensor cores): "

# (source, label, [edits of one version of the source, edits of another, ...])
# with edits = [(file, text, replacement), ...]
VARIANTS = [
    ("flash_attention", "base", [[]]),
    ("flash_attention", "lb6", [[("flash_attention.cu", K2_BOUNDS,
                                  K2_BOUNDS.replace("kThreads)", "kThreads, 6)"))]]),
    ("flash_attention", "lb8", [[("flash_attention.cu", K2_BOUNDS,
                                  K2_BOUNDS.replace("kThreads)", "kThreads, 8)"))]]),
    ("flash_attention", "noexp", [[("flash_attention.cu", "p[u][e] = coati::exp2_fast(",
                                    "p[u][e] = (")]]),
    ("flash_attention", "noarith", [[("flash_attention.cu",
                                      "    if (live) {\n      if (j == 0) {",
                                      "    if (live && seq < 0) {\n      if (j == 0) {")]]),
    ("flash_attention", "l2_256", [[("mma.cuh", COPY,
                                     COPY.replace("global [", "global.L2::256B ["))]]),
    ("packed_attention", "base", [[]]),
    ("packed_attention", "lb5", [[("packed_attention.cu", K5F_BOUNDS,
                                   K5F_BOUNDS.replace("kTcThreads)", "kTcThreads, 5)"))]]),
    ("packed_attention", "noexp", [[("packed_attention.cu", "s[n][e] = coati::exp2_fast(",
                                     "s[n][e] = (")]]),
    ("packed_attention_bwd", "base", [[]]),
    # K5b's variants, first as they apply to its tensor-core body (an edit
    # that replaces a text by itself only checks that it is there), then to
    # the older source with CUDA-core bodies only, kept now for float32
    ("packed_attention_bwd", "noproducts", [
        [("packed_attention_bwd.cu", TC_BWD, TC_BWD), ("mma.cuh", MMA, NO_MMA)],
        [("packed_attention_bwd.cu", "for (int d = 0; d < DH; ++d) {\n      const float qd",
          "for (int d = 0; d < DH * (scale < 0.f); ++d) {\n      const float qd"),
         ("packed_attention_bwd.cu", "for (int j = part; j <= r; j += PARTS) {",
          "for (int j = part; j <= r && scale < 0.f; j += PARTS) {"),
         ("packed_attention_bwd.cu", "for (int r = j + part; r < seq; r += PARTS) {",
          "for (int r = j + part; r < seq && scale < 0.f; r += PARTS) {")],
    ]),
    ("packed_attention_bwd", "nophase2", [
        [("packed_attention_bwd.cu", TC_PHASE2, "  if (scale < 0.f)" + TC_PHASE2)],
        [("packed_attention_bwd.cu", "  for (int j = warp; j < seq; j += kWarps) {",
          "  for (int j = warp; j < seq && scale < 0.f; j += kWarps) {")],
    ]),
    ("packed_attention_bwd", "stage_only", [
        [("packed_attention_bwd.cu", TC_PHASE1, "  if (scale < 0.f)" + TC_PHASE1),
         ("packed_attention_bwd.cu", TC_PHASE2, "  if (scale < 0.f)" + TC_PHASE2)],
        [("packed_attention_bwd.cu", "  for (int r = warp; r < seq; r += kWarps) {",
          "  for (int r = warp; r < seq && scale < 0.f; r += kWarps) {"),
         ("packed_attention_bwd.cu", "  for (int j = warp; j < seq; j += kWarps) {",
          "  for (int j = warp; j < seq && scale < 0.f; j += kWarps) {")],
    ]),
]
KERNELS = {"k2": "flash_attention", "k5f": "packed_attention", "k5b": "packed_attention_bwd"}
K2_SHAPES = ((1024, 250), (1024, 128), (1024, 96), (1024, 3))
K5F_SHAPES = ((1024, 96), (1024, 128), (160, 32), (160, 48), (160, 80), (1024, 3))
K5B_SHAPES = ((160, 80), (160, 48), (160, 32), (1024, 96), (1024, 128))
H, DH = 16, 16


def build_variants(variants, workdir: Path, csrc: Path, headers=build.HEADERS, parent=None):
    """Compile every variant of `variants` whose edits apply to the sources
    in `csrc`, all at once, and with `parent` (another directory of sources)
    each variant source's unedited copy from there, labelled `parent`;
    returns {(source, label): (loaded library, the variant's source text)},
    {(source, label): ptxas usage of its kernels} and the labels skipped
    because no set of edits applied."""
    jobs, skipped = [], []
    todo = [(source, label, alternatives, csrc) for source, label, alternatives in variants]
    if parent:
        todo += [(source, "parent", [[]], Path(parent))
                 for source in dict.fromkeys(v[0] for v in variants)]
    for source, label, alternatives, directory in todo:
        files = {f: (directory / f).read_text() for f in (f"{source}.cu", *headers)
                 if (directory / f).exists()}
        edits = next((e for e in alternatives
                      if all(f in files and text in files[f] for f, text, _ in e)), None)
        if edits is None:
            skipped.append(f"{source}/{label}")
            continue
        for name, text, replacement in edits:
            files[name] = files[name].replace(text, replacement)
        src = workdir / f"{source}_{label}"
        src.mkdir()
        for name, text in files.items():
            (src / name).write_text(text)
        lib = src / f"lib{source}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src / f"{source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, label, lib, proc, files[f"{source}.cu"]))
    libs, usage = {}, {}
    for source, label, lib, proc, text in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}/{label}:\n{log}")
        usage[(source, label)] = cs.ptxas_usage(log)
        libs[(source, label)] = (ctypes.CDLL(str(lib)), text)
    return libs, usage, skipped


def _inputs(gen, b, t):
    qkv = torch.randn(b, t, 3 * H * DH, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (x.view(b, t, H, DH) for x in qkv.split(H * DH, dim=-1))
    out = torch.empty(b, t, H, DH, dtype=torch.bfloat16, device="cuda")
    ref = causal_attention(q, k, v, torch.float32).float()
    return q, k, v, out, ref, 2 * cs.BF16_ULP * float(ref.abs().max())


def _timed(run, outs, refs, tols):
    """[ms, agrees with the plain version]"""
    err = run()
    if err != 0:
        raise RuntimeError(f"CUDA error {err}")
    torch.cuda.synchronize()
    agrees = all(float((o.float() - r).abs().max()) <= t for o, r, t in zip(outs, refs, tols))
    return [cs.time_ms(run), agrees]


def measure(libs, emit) -> None:
    stream = build.stream_handle(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(DH)
    bf16 = build.DTYPE_CODES[torch.bfloat16]

    def entry(source, name, argtypes):
        out = {}
        for (src, label), (lib, text) in libs.items():
            if src == source:
                fn = getattr(lib, name)
                fn.argtypes = argtypes(text) if callable(argtypes) else argtypes
                fn.restype = ctypes.c_int
                out[label] = (fn, text)
        return out

    k2 = entry("flash_attention", "flash_causal_attention", kf._ARGTYPES)
    for b, t in K2_SHAPES if k2 else ():
        q, k, v, out, ref, tol = _inputs(gen, b, t)
        row = {"kernel": "flash_causal_attention", "shape": [b, t, H, DH]}
        for label, (fn, _) in k2.items():
            row[label] = _timed(lambda: fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, H, DH, bf16,
                q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                v.stride(1), scale, stream), [out], [ref], [tol])
        emit(row)

    k5f = entry("packed_attention", "packed_causal_attention", kp._ARGTYPES)
    for b, t in K5F_SHAPES if k5f else ():
        q, k, v, out, ref, tol = _inputs(gen, b, t)
        rule = kp.head_group(t, H, DH, torch.bfloat16)
        row = {"kernel": "packed_causal_attention", "shape": [b, t, H, DH], "rule_group": rule}
        for label, (fn, _) in k5f.items():
            groups = [g for g in (1, 2, 4, 8, 16)
                      if g * kp.staged_bytes(t, DH, torch.bfloat16) <= 48 * 1024]
            for g in groups if label == "base" else [rule]:
                row[f"{label}_g{g}"] = _timed(lambda: fn(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, H, DH, g,
                    bf16, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                    v.stride(1), scale, stream), [out], [ref], [tol])
        emit(row)

    # K5b: the entry point of the tensor-core source takes a head group after
    # Dh, the older one does not
    def bwd_argtypes(text):
        grouped = "int group, int dtype" in text
        return kp._BWD_ARGTYPES if grouped else [t for i, t in enumerate(kp._BWD_ARGTYPES)
                                                 if i != 11]

    k5b = entry("packed_attention_bwd", "packed_causal_attention_bwd", bwd_argtypes)
    for b, t in K5B_SHAPES if k5b else ():
        q, k, v, _, _, _ = _inputs(gen, b, t)
        g = torch.randn(b, t, H, DH, generator=gen, device="cuda").to(torch.bfloat16)
        refs = [r.float() for r in causal_attention_backward(q, k, v, g)]
        tols = [2 * cs.BF16_ULP * float(r.abs().max()) for r in refs]
        outs = [torch.empty(b, t, H, DH, dtype=torch.bfloat16, device="cuda") for _ in range(3)]
        rule = kp.bwd_head_group(t, H, DH) if hasattr(kp, "bwd_head_group") else None
        row = {"kernel": "packed_causal_attention_backward", "shape": [b, t, H, DH],
               "rule_group": rule}
        for label, (fn, text) in k5b.items():
            grouped = "int group, int dtype" in text
            if not grouped:
                groups = [None]
            elif label == "base":
                groups = [g_ for g_ in (1, 2, 4, 8, 16)
                          if kp.bwd_smem_bytes(t, DH, g_) <= kp.MAX_SHARED_BYTES]
            else:
                groups = [rule]
            for grp in groups:
                head = [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                        *(o.data_ptr() for o in outs), b, t, H, DH]
                tail = [bf16, q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
                        v.stride(1), scale, stream]
                args = head + ([grp] if grouped else []) + tail
                key = label if grp is None else f"{label}_g{grp}"
                row[key] = _timed(lambda: fn(*args), outs, refs, tols)
        emit(row)


def run(description: str, variants, kernels, measure_fn) -> int:
    """The command line of a variants script: builds the variants of the
    chosen sources, prints their ptxas usage and the timings of measure_fn."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--out", help="also append every JSON line to this file")
    parser.add_argument("--csrc", default=str(build.CSRC_DIR),
                        help="directory of the CUDA sources to vary (default: the package's)")
    parser.add_argument("--parent",
                        help="also build each chosen source unedited from this directory "
                             "(an older commit's coati_tpu_torch/csrc), labelled parent, "
                             "to time the two in one run")
    parser.add_argument("--only", default=",".join(kernels),
                        help=f"comma-separated kernels, of {','.join(kernels)}")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print(f"{Path(sys.argv[0]).name}: no CUDA device", file=sys.stderr)
        return 2
    log = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if log:
            log.write(line + "\n")

    chosen = {kernels[k] for k in args.only.split(",")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "sm_clock_mhz": cs.sm_clock_hz() / 1e6,
          "csrc": args.csrc, "parent": args.parent})
    with tempfile.TemporaryDirectory() as tmp:
        libs, usage, skipped = build_variants(
            [v for v in variants if v[0] in chosen], Path(tmp), Path(args.csrc),
            parent=args.parent)
        for (source, label), u in usage.items():
            emit({"variant": f"{source}/{label}", "ptxas": u})
        if skipped:
            emit({"skipped": skipped})
        measure_fn(libs, emit)
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(run(__doc__.splitlines()[0], VARIANTS, KERNELS, measure))
