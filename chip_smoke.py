#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coati_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

With CHIP_SMOKE_LOG=<file> in the environment, every JSON line it prints is
also appended to that file.

Phases, in order; any failure ends the run with a non-zero exit. The
first line names the host CPU (vendor, model, cores), on which every host
number is taken.

 1. build: nvcc builds every kernel under coati_tpu_torch/csrc for sm_90a,
    one process per source, all at once; ptxas's registers and spills of
    each kernel are reported, and the bf16 tensor-core kernels and every
    form of K1 must not spill.
 2. kernels: each kernel against its plain PyTorch version on the card, on
    the main paths' shapes (for the tensor-core bodies also the edges of
    their tiles, the other head sizes and the trainer's shapes; K1 in every
    form at the positions the paths decode, 3 to about 40, and at 0, 95 and
    249; K1, K5b, K3's bf16 body and all but dc of K4's must repeat bit for
    bit over two launches; K3's bf16 body must refuse Hm 257 before any
    launch), within a stated tolerance; each timed with CUDA events (median
    of 25 launches after warm-up, L2 flushed before each, the host's launch
    hidden behind a spin on the card), beside its bound and, where one
    PyTorch call computes the same function, that call (a yardstick only:
    the port never calls it); K2, K5f and K3 also beside the floor of their
    exponentials. Then routing:
    forward + backward of the trainer's attention through K5f + K5b and
    through K2 + its replayed plain backward, side by side.
 3. chem (host only): the port's chemistry core. The native C libraries
    (coati_tpu_torch/native/*.c, built with cc) must build and load; the
    canonicalizer is timed over all 120,000 lines of
    corpora/chembl_synth_v1.smi.gz with its cache cleared (seconds,
    molecules/s, and how many the native and the Python path answered), and
    again warm; on a seeded sample of 2,000 lines its native path must equal
    its Python path byte for byte, every permuted writing must canonicalize
    to the line's canonical form, and the native matcher must split the
    tokenizer's text as the Python scan does.
 4. paths: the trained grande document docs/eval_model_r5.pkl on the card,
    through the user entry points. Each path starts with every kernel's
    launch count set to 0 and ends by reading the counts; runs through the
    plain versions, made for comparison, lie outside those windows.
    smiles: (a) an fp32 greedy round trip of 64 SMILES through the kernels
    and through the plain versions; (b) the production setting, bf16 with
    an int8 KV cache, at batch 1024, k 100, inverse temperature 2, at the
    document's n_seq 250 and at total_len 96, each with its encode timed
    alone and one round trip traced by torch.profiler (device time by
    kernel, the card's idle share).
    points: the 1,024 point clouds of coati_tpu_torch/data/points_fixture.npz
    through encode_points in fp32, by the message kernel and by its plain
    version; the cosine of each point embedding with the same molecule's
    SMILES embedding; points_to_2d_batch in the production setting, timed
    and traced the same way.
    points_from_smiles: the fixture's 1,024 SMILES embedded by the port's
    own conformer embedder (chem/conformers.py, host seconds); the atoms
    must equal the fixture's in every row and, in every row, the pairwise
    distances the fixture's (written by coati_tpu) within 1e-4 Angstrom
    (the worst row is printed); then points_to_2d_batch on those coordinates in the
    production setting: every row decodes, K3 launches once per EGNN layer
    and the int8 K1 every decode step.
    packed: the total_len 96 production round trip again under
    prefill_kernel="packed", which sends every full-sequence attention to
    the short-sequence kernel.
    k1_positions: after the paths, K1's int8 form timed at every position
    each production round trip decoded, and its time in each call weighted
    by those launches, beside its bound and the same launches priced at
    pos 95. Every traced call lists the device time of each of the port's
    kernels by name.
    train: train_autoencoder with the grande recipe as it is written (16 x
    256 transformer, 5 x 256 EGNN, bf16 over float32 masters, batch 160,
    n_seq 80, remat of the transformer blocks, every row canonicalized, 30%
    of the targets permuted) on the fixture's molecules, from a seeded fresh
    model and a seeded global random module (permute_smiles draws from
    it), so a run repeats its batches: 3 warm-up and 20 timed steps, then
    a few more steps split into forward, backward and optimizer by CUDA
    events and traced by torch.profiler. Every loss must be finite, the autoregressive loss must
    fall, and the backward kernels must launch. The host pipeline is
    reported beside the step: the transform's seconds a batch inside the
    run, and replayed after it on the same raw batches, drawn again from
    the seeded pipe so that no copy is taken inside the run, cold (caches
    cleared) and warm, with the share of permuted targets and the
    canonicalizations each path answered.
 5. train_fp32_vs_plain: one float32 training step at full width (4
    transformer layers, 2 EGNN layers, batch 64) from the same weights,
    batch and clip-token choice, through the kernels and through their plain
    versions: the loss and every parameter's gradient must agree. Once more
    at T 200, batch 32, where K2 carries the trunk and its backward replays
    the plain attention.
 6. coati2: COATI2 grande (16 x 512, 16 heads of 32, n_seq 128, SwiGLU-resnet
    heads, the coati2_12_12 vocabulary) from seeded fresh weights, written
    as a reference-format document and read back by load_coati2 on the card
    (after the COATI paths, before train). (a) An fp32 greedy round trip of
    64 corpus SMILES through the kernels and through the plain versions:
    embeddings within 1e-5, tokens equal on at least 63 rows, and a row that
    differs must first differ where the plain run's top-2 logit margin is
    under 1e-4 (printed); (b) the production setting, bf16 with the int8 KV
    cache, on the first 1,024 corpus SMILES that fit n_seq, k 100, inverse
    temperature 2, timed and traced (untrained weights rarely emit [STOP],
    so a call decodes to n_seq); (c) one property-conditioned decode
    ([PROPS]...[ENDPROPS][SMILES]) through hcoati_to_2d_batch. K2 and K1
    run at Dh 32. The kernels phase also holds K2, K1, K5f and K5b at
    COATI2's shapes.
 7. coati2_train (after train_fp32_vs_plain): train_coati2 with the grande
    recipe of examples/train_coati2.py in bf16 on corpus rows with only a
    'smiles' column (the transform computes every property, as a user's
    run does), batch 160, 3 warm-up and 10 timed steps from a seeded fresh
    model and a seeded global random module: K5f 64 and K5b 32 times a
    step, every loss finite, ar_loss falls; the transform's seconds a batch
    in the run and its share of the step (`coati2_host_pipeline`); the
    run's document reloaded by load_coati2 encodes as the model does; three
    steps traced on batches made before. Then coati2_fp32_vs_plain: one
    float32 step at full width (4 layers), batch 32, through the kernels
    and through the plain versions: loss within 1e-5 relative, every
    gradient within 1e-4 x max(1, max |plain|).
 8. report: the card's name and power limit, one `kernels` JSON line, and
    as the last line {"ok": true, "device": {...}}.

Every number printed is measured in this run, on this card, except the
bounds, which are computed from this run's shapes and the card's published
peaks (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16; 67 TFLOP/s fp32; 16
special-function results a clock on each of 132 SMs, at the highest SM
clock that nvidia-smi reports).
"""

from __future__ import annotations

import contextlib
import gzip
import itertools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DOC = ROOT / "docs" / "eval_model_r5.pkl"
CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0**-7  # spacing of bf16 values in [1, 2)
# special-function results (ex2) a clock: 16 on each of an H100's 132 SMs
SFU_RESULTS_PER_CLOCK = 132 * 16

# the SMILES of bench.py, the JAX package's throughput workload
BENCH_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
    "Clc1ccccc1C2=NCC(=O)Nc3ccc(cc23)N(=O)=O",
    "CC1=CC(=O)C=CC1=O",
    "NC(=O)c1ccc(N)cc1",
    "COc1cc2c(cc1OC)CC(N)C2",
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",
    "CC(N)Cc1ccccc1",
    "OC(=O)c1ccccc1O",
    "Nc1ccc(cc1)S(=O)(=O)N",
    "CCOC(=O)c1ccccc1N",
    "CN(C)CCOC(c1ccccc1)c1ccccc1",
]


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if os.environ.get("CHIP_SMOKE_LOG"):
        with open(os.environ["CHIP_SMOKE_LOG"], "a") as log:
            log.write(line + "\n")


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", flush=True)
        sys.exit(1)


# ------------------------------------------------------------- timing


_FLUSH = None


def time_ms(fn, n: int = 25, warmup: int = 3, spin: int = 200_000, flush=None) -> float:
    """Median device time of fn() in ms, by CUDA events around each call,
    with a 256 MB write before each to evict the 50 MB L2 (or `flush()`).
    A spin of `spin` clock cycles on the card (about 0.1 ms by default)
    follows it, so that the host has enqueued the start event and fn's
    kernels before the card reaches them: the time between the events is
    the card's, not the host's launch."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        if flush:
            flush()
        else:
            _FLUSH.zero_()
        torch.cuda._sleep(spin)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes: float, n_ops: float, dtype: torch.dtype):
    """(least time in ms, what bounds it): bytes over the memory rate, or
    operations over the peak rate for the inputs' type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


_SM_CLOCK_HZ = None


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    global _SM_CLOCK_HZ
    if _SM_CLOCK_HZ is None:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        )
        _SM_CLOCK_HZ = float(out.stdout.split()[0]) * 1e6
    return _SM_CLOCK_HZ


def attention_exps(name: str, dtype: torch.dtype, b: int, t: int, h: int) -> int:
    """Exponentials one call of K2 or K5f takes, counted at the kernel's
    tile granularity. bf16 bodies: K2 takes one per (query, key) of each
    warp's 16 rows and the 16-key chunks it computes (all of every key tile
    below the diagonal, those up to its last row on it), and two a lane per
    key tile to rescale; K5f one per (query, key) of its 16 x 16 tiles on
    and below the diagonal. The float32 bodies take one per causal pair."""
    if dtype == torch.float32:
        return b * h * t * (t + 1) // 2
    n = 0
    if name == "flash_causal_attention":
        for i in range(-(-t // 64)):
            for w in range(4):
                if 64 * i + 16 * w < t:
                    n += 16 * (64 * i + 16 * (w + 1)) + 64 * (i + 1)
    else:
        n = sum(16 * 16 * (i + 1) for i in range(-(-t // 16)))
    return b * h * n


def tolerance(ref: torch.Tensor, dtype: torch.dtype, fp32_tol: float) -> float:
    """bf16 output: 2 bf16 ulps of the output scale (rounding of the output
    and of the plain version's bf16 scores and probs); float32: fp32_tol
    (summation order only)."""
    if dtype == torch.bfloat16:
        return 2 * BF16_ULP * float(ref.float().abs().max())
    return fp32_tol


# -------------------------------------------------------------- phases


def _kernel_label(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled symbol:
    packed_causal_bf16_kernel<16,8> for ..25packed_causal_bf16_kernelILi16ELi8EEEv..."""
    # every digit run that could be a length prefix, suffixes of runs too
    for m in re.finditer(r"(?=(\d+)[A-Za-z_])", mangled):
        start = m.start() + len(m.group(1))
        name = mangled[start:start + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"I(.*?)EEv", mangled[start + len(name):])
            if not args:
                return name
            text = re.sub(r"L[a-z](\d+)E", r"\1,", args.group(1).replace("13__nv_bfloat16", "bf16,"))
            return f"{name}<{re.sub(r'^f', 'f32,', text).rstrip(',')}>"
    return mangled


def ptxas_usage(log: str) -> dict:
    """{kernel: {"registers": n, "spill_bytes": stores + loads}} from the
    -Xptxas -v output of one nvcc run."""
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = _kernel_label(m.group(1))
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m.group(1))
    return usage


def phase_build():
    from coati_tpu_torch.ops.kernels import build

    seconds = build.build()
    usage = {name: ptxas_usage(log) for name, log in build.BUILD_LOG.items()}
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": round(seconds, 2),
          "arch": "sm_90a", "ptxas": usage})
    # the tensor-core bodies keep their scores (attention), their dW2 slice
    # (K4) and their z2 tile and range sums (K3) in registers, and K1 every
    # form its two chunks of the cache in flight: a spill would put them in
    # local memory
    spilled = [k for src in ("flash_attention", "packed_attention", "packed_attention_bwd",
                             "egnn_messages_bwd", "egnn_messages", "decode_attention")
               for k, u in usage.get(src, {}).items()
               if ("bf16" in k or src == "decode_attention") and u.get("spill_bytes", 0) > 0]
    check(not spilled, f"kernels spill registers: {spilled}")


def _attention_case(name, b, t, h, dh, dtype, gen, timed=True):
    """A full-sequence attention wrapper (K2 `flash_causal_attention` or
    K5f `packed_causal_attention`) against causal_attention; K5f's case also
    times K2 on the same inputs."""
    from coati_tpu_torch.ops.attention import causal_attention
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    kernel = {"flash_causal_attention": flash_causal_attention,
              "packed_causal_attention": packed_causal_attention}[name]
    # strided q/k/v views of one fused projection, as the model passes them
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    out = kernel(q, k, v)
    ref = causal_attention(q, k, v, torch.float32)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = tolerance(ref, dtype, 1e-5)
    elt = torch.finfo(dtype).bits // 8
    bound, by = bound_ms(4 * b * t * h * dh * elt, 4 * b * h * (t * (t + 1) // 2) * dh, dtype)
    case = {
        "kernel": name, "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
        "max_abs_err": err, "tol": tol, "ok": err <= tol, "bound_ms": bound, "bound_by": by,
    }
    if not timed:
        return case
    exps = attention_exps(name, dtype, b, t, h)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    case.update({
        "ms": time_ms(lambda: kernel(q, k, v)),
        "plain_ms": time_ms(lambda: causal_attention(q, k, v, torch.float32)),
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        ),
        # the exponentials' floor on the special-function units, at the
        # highest SM clock
        "exps": exps, "sm_clock_mhz": sm_clock_hz() / 1e6,
        "exp_floor_ms": exps / (SFU_RESULTS_PER_CLOCK * sm_clock_hz()) * 1e3,
    })
    case["vs_library"] = case["ms"] / case["library_ms"]
    if kernel is packed_causal_attention:
        case["k2_ms"] = time_ms(lambda: flash_causal_attention(q, k, v))
    return case


def _fixture_geometry(rows=None, cutoff=5.0):
    """(d2, w, atom counts) of the fixture's molecules on the card, as
    egnn_forward computes them at a message cutoff in Angstrom: 5 in the
    trained document, 12 in the grande training recipe."""
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.egnn import pair_geometry

    _, atoms, coords = load_points_fixture()
    atoms, coords = atoms[:rows], coords[:rows]
    mask = torch.as_tensor(atoms > 0, device="cuda").float()
    d2, w = pair_geometry(mask, torch.as_tensor(coords, device="cuda"), cutoff)
    return d2, w, (atoms > 0).sum(1)


def _random_geometry(counts, n, gen):
    """(d2, w) of random point clouds with the given atom counts: points a
    few Angstrom apart, so that part of the pairs passes the cutoff."""
    from coati_tpu_torch.models.egnn import pair_geometry

    counts = torch.as_tensor(counts, device="cuda")
    mask = (torch.arange(n, device="cuda")[None, :] < counts[:, None]).float()
    coords = 3.0 * torch.randn(len(counts), n, 3, generator=gen, device="cuda")
    return pair_geometry(mask, coords, 5.0)


def _messages_case(d2, w, hm, mm_dtype, gen, label, timed=True):
    """K3 against its plain version (which walks the batch in chunks) on
    the pair geometry (d2, w), with random a, c and weights at the scale
    the encoder gives them. In the bf16-product mode a second launch must
    repeat the first bit for bit."""
    from coati_tpu_torch.ops import egnn_messages as plain
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages

    b, n, _ = d2.shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
    wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
    w2 = rand(hm, hm, scale=hm**-0.5)
    args = (a, c, d2, w, wd, b1, w2, b2)
    out = egnn_messages(*args, mm_dtype=mm_dtype)
    again = egnn_messages(*args, mm_dtype=mm_dtype)
    ref = plain.egnn_messages(*args, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    repeats = bool(torch.equal(out, again))
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    # float32: the order of the sums only (Hm products a pair, up to N pairs
    # an atom). bf16 product: the plain version rounds e1 and w2 to bf16 the
    # same way, but its SiLU and the kernel's differ in the last float32 bit,
    # which now and then rounds an e1 to the neighbouring bf16 value
    # (2^-8 relative, times one w2 entry, on one pair's message).
    tol = (1e-5 if mm_dtype == torch.float32 else 1e-3) * scale
    pairs = int((w != 0).sum())
    n_bytes = 4 * (3 * b * n * hm + 2 * b * n * n + hm * hm + 3 * hm)
    bound, by = bound_ms(n_bytes, pairs * (2 * hm * hm + 8 * hm), mm_dtype)
    exps = 2 * hm * pairs  # the two SiLUs of each live pair, an exponential each
    case = {
        "kernel": "egnn_messages", "case": label, "shape": [b, n, hm],
        "mm_dtype": str(mm_dtype)[6:], "live_pairs": pairs, "dense_pairs": b * n * n,
        "padding_rows_zero": bool((out[w.abs().sum(-1) == 0] == 0).all()),
        "repeats_bit_for_bit": repeats,
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
        # the exponentials' floor on the special-function units, at the
        # highest SM clock (each SiLU also takes a reciprocal there)
        "exps": exps, "exp_floor_ms": exps / (SFU_RESULTS_PER_CLOCK * sm_clock_hz()) * 1e3,
    }
    case["ok"] = (case["ok"] and case["padding_rows_zero"]
                  and (repeats or mm_dtype == torch.float32))
    if timed:
        case["ms"] = time_ms(lambda: egnn_messages(*args, mm_dtype=mm_dtype))
        case["plain_ms"] = time_ms(
            lambda: plain.egnn_messages(*args, mm_dtype=mm_dtype), n=3, warmup=1
        )
    return case


def _messages_refusal_case(gen):
    """K3's bf16-product body keeps W2 in shared memory and takes Hm <= 256:
    at Hm 257 the wrapper must raise before any launch."""
    from coati_tpu_torch.ops.kernels.egnn_messages import FWD_MAX_HM, egnn_messages

    d2, w = _random_geometry([5, 3], 5, gen)
    hm = FWD_MAX_HM + 1
    x = torch.zeros(2, 5, hm, device="cuda")
    v, m = torch.zeros(hm, device="cuda"), torch.zeros(hm, hm, device="cuda")
    before = egnn_messages.launches
    try:
        egnn_messages(x, x, d2, w, v, v, m, v, mm_dtype=torch.bfloat16)
        message = None
    except ValueError as exc:
        message = str(exc)
    launched = egnn_messages.launches - before
    return {"kernel": "egnn_messages", "case": "refuses_hm_257", "shape": [2, 5, hm],
            "mm_dtype": "bfloat16", "raised": message, "launches": launched,
            "ok": message is not None and launched == 0}


def _attention_bwd_case(b, t, h, dh, dtype, gen, timed=True):
    """K5b `packed_causal_attention_backward` against
    causal_attention_backward, on strided q, k, v and a contiguous g; a
    second launch on the same inputs must repeat the first bit for bit."""
    from coati_tpu_torch.ops.attention import causal_attention_backward
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention_backward

    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    g = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(dtype)
    outs = packed_causal_attention_backward(q, k, v, g)
    again = packed_causal_attention_backward(q, k, v, g)
    refs = causal_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    repeats = all(torch.equal(x, y) for x, y in zip(outs, again))
    # float32: the order of sums of up to T terms, on gradients that reach
    # 6-7 here; bf16: 2 ulps of each output's scale, as for the forward
    errs = [float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs)]
    tols = [tolerance(r, dtype, 2e-5) for r in refs]
    elt = torch.finfo(dtype).bits // 8
    # five products of 2 * Dh operations per causal pair: the scores, dP, dq, dk, dv
    bound, by = bound_ms(7 * b * t * h * dh * elt, 10 * b * h * (t * (t + 1) // 2) * dh, dtype)
    case = {
        "kernel": "packed_causal_attention_backward", "shape": [b, t, h, dh],
        "dtype": str(dtype)[6:], "max_abs_err": max(errs), "max_abs_err_dq_dk_dv": errs,
        "tol_dq_dk_dv": tols, "repeats_bit_for_bit": repeats,
        "ok": repeats and all(e <= t_ for e, t_ in zip(errs, tols)),
        "bound_ms": bound, "bound_by": by,
    }
    if not timed:
        return case
    qt, kt, vt, gt = (x.transpose(1, 2).detach() for x in (q, k, v, g))
    for x in (qt, kt, vt):
        x.requires_grad_(True)
    sdpa = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    case.update({
        "ms": time_ms(lambda: packed_causal_attention_backward(q, k, v, g)),
        "plain_ms": time_ms(lambda: causal_attention_backward(q, k, v, g)),
        # the library's backward alone, on a retained graph
        "library_ms": time_ms(
            lambda: torch.autograd.grad(sdpa, (qt, kt, vt), gt, retain_graph=True)
        ),
    })
    case["vs_library"] = case["ms"] / case["library_ms"]
    return case


def _messages_bwd_case(d2, w, hm, mm_dtype, gen, label, timed=True):
    """K4 `egnn_messages_backward` against its plain version on the pair
    geometry (d2, w), inputs as in _messages_case and a random cotangent. In
    the bf16-product mode a second launch must repeat da and the parameter
    gradients (dwd, db1, dW2, db2) bit for bit."""
    from coati_tpu_torch.ops import egnn_messages as plain
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages_backward

    b, n, _ = d2.shape

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    a, c = rand(b, n, hm, scale=0.5), rand(b, n, hm, scale=0.5)
    wd, b1, b2 = rand(hm, scale=0.1), rand(hm, scale=0.1), rand(hm, scale=0.1)
    w2 = rand(hm, hm, scale=hm**-0.5)
    args = (a, c, d2, w, wd, b1, w2, b2, rand(b, n, hm))
    outs = egnn_messages_backward(*args, mm_dtype=mm_dtype)
    again = egnn_messages_backward(*args, mm_dtype=mm_dtype)
    refs = plain.egnn_messages_backward(*args, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    names = ("da", "dc", "dwd", "db1", "dw2", "db2")
    # all but dc, which the bf16 body sums by float32 atomics
    repeats = all(torch.equal(x, y) for i, (x, y) in enumerate(zip(outs, again)) if i != 1)
    errs = {k: float((o - r).abs().max()) for k, o, r in zip(names, outs, refs)}
    scales = {k: max(1.0, float(r.abs().max())) for k, r in zip(names, refs)}
    # float32: the order of the sums only, by atomics for all but da; da and
    # dc sum up to N pairs, the parameter gradients every live pair (2e5 on
    # the fixture), so each is held relative to its own largest entry. bf16
    # products: as for K3, a last-bit difference of a SiLU now and then
    # rounds an e1 or a dz2 to the neighbouring bf16 value.
    rel = 1e-5 if mm_dtype == torch.float32 else 1e-3
    pairs = int((w != 0).sum())
    dead_i, dead_j = w.abs().sum(-1) == 0, w.abs().sum(-2) == 0
    zero = bool((outs[0][dead_i] == 0).all()) and bool((outs[1][dead_j] == 0).all())
    n_bytes = 4 * (5 * b * n * hm + 2 * b * n * n + 2 * hm * hm + 6 * hm)
    bound, by = bound_ms(n_bytes, pairs * (6 * hm * hm + 24 * hm), mm_dtype)
    case = {
        "kernel": "egnn_messages_backward", "case": label, "shape": [b, n, hm],
        "mm_dtype": str(mm_dtype)[6:], "live_pairs": pairs, "dense_pairs": b * n * n,
        "dead_rows_and_columns_zero": zero, "repeats_but_dc": repeats,
        "max_abs_err": max(errs.values()), "max_abs_err_by_output": errs,
        "tol_by_output": {k: rel * scales[k] for k in names},
        "ok": zero and (repeats or mm_dtype == torch.float32)
        and all(errs[k] <= rel * scales[k] for k in names),
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }
    if timed:
        case["ms"] = time_ms(lambda: egnn_messages_backward(*args, mm_dtype=mm_dtype))
        case["plain_ms"] = time_ms(
            lambda: plain.egnn_messages_backward(*args, mm_dtype=mm_dtype), n=3, warmup=1
        )
    return case


def _decode_case(b, t, h, dh, pos, q_dtype, kv, gen):
    """kv: a cache dtype (float32, bfloat16) or "int8/<scale dtype>"."""
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops import attention as plain
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    q = torch.randn(b, h, dh, generator=gen, device="cuda").to(q_dtype)
    k = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    v = torch.randn(b, t, h, dh, generator=gen, device="cuda")
    live = pos + 1
    if isinstance(kv, str):
        scale_dtype = {"int8/float32": torch.float32, "int8/bfloat16": torch.bfloat16}[kv]
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        ks, vs = ks.to(scale_dtype), vs.to(scale_dtype)
        name = "decode_attention_quant"
        run = lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, pos)  # noqa: E731
        run_plain = lambda: plain.decode_attention_quant(q, k8, ks, v8, vs, pos)  # noqa: E731
        scale_elt = torch.finfo(scale_dtype).bits // 8
        n_bytes = 2 * b * h * dh * q.element_size() + live * b * h * (2 * dh + 2 * scale_elt)
        # int8 data times a float query: count the products at the fp32 rate
        ops_dtype, library = torch.float32, None
    else:
        k, v = k.to(kv), v.to(kv)
        name = "decode_attention"
        run = lambda: k1.decode_attention(q, k, v, pos)  # noqa: E731
        run_plain = lambda: plain.decode_attention(q, k, v, pos)  # noqa: E731
        n_bytes = 2 * b * h * dh * q.element_size() + live * b * h * dh * 2 * k.element_size()
        ops_dtype = kv
        q4, kl, vl = q[:, :, None, :], k[:, :live].transpose(1, 2), v[:, :live].transpose(1, 2)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q4, kl, vl)  # noqa: E731
    out, again, ref = run(), run(), run_plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # int8 with a float32 query compares in float32, before any final cast
    tol = tolerance(ref, q_dtype, 1e-4 if isinstance(kv, str) else 1e-5)
    bound, by = bound_ms(n_bytes, 4 * b * h * live * dh, ops_dtype)
    repeats = bool(torch.equal(out, again))  # the states merge in a fixed order
    return {
        "kernel": name, "shape": [b, t, h, dh], "pos": pos, "q_dtype": str(q_dtype)[6:],
        "kv": kv if isinstance(kv, str) else str(kv)[6:],
        "max_abs_err": err, "tol": tol, "repeats": repeats, "ok": err <= tol and repeats,
        "ms": time_ms(run), "plain_ms": time_ms(run_plain), "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library) if library else None,
    }


def attention_cases(gen):
    """K2 and K5f against their plain version: the main paths' shapes, the
    edges of the bf16 bodies' tiles (64 keys and 16 query rows for K2,
    16 x 16 for K5f), the other head sizes and the trainer's shapes."""
    bf16, f32 = torch.bfloat16, torch.float32
    k2, k5f = "flash_causal_attention", "packed_causal_attention"
    shapes = [
        (k2, 1024, 96, 16, 16, bf16),
        (k2, 1024, 96, 16, 16, f32),
        (k2, 1024, 250, 16, 16, bf16),
        (k2, 1024, 250, 16, 16, f32),
        (k2, 1024, 3, 16, 16, bf16),  # prefill of [CLIP][UNK][SMILES]
        (k2, 3, 37, 4, 32, f32),
        (k2, 3, 37, 4, 32, bf16),
        (k2, 2, 70, 2, 64, f32),
        *[(k2, 64, t, 16, 16, bf16) for t in (1, 16, 17, 64, 65, 127, 128, 250)],
        (k2, 4, 250, 8, 32, bf16),
        (k2, 4, 250, 4, 64, bf16),
        (k5f, 1024, 96, 16, 16, bf16),
        (k5f, 1024, 96, 16, 16, f32),
        (k5f, 1024, 3, 16, 16, bf16),
        (k5f, 1024, 128, 16, 16, bf16),
        (k5f, 1024, 128, 16, 16, f32),
        (k5f, 3, 37, 4, 32, f32),
        (k5f, 2, 70, 2, 64, bf16),
        *[(k5f, 16, t, h, dh, bf16) for t in (1, 17, 65, 127)
          for h, dh in ((8, 16), (4, 32), (6, 64))],
        (k5f, 160, 48, 16, 16, bf16),  # the trainer's batches
        (k5f, 160, 80, 16, 16, bf16),
    ]
    return [_attention_case(*shape, gen) for shape in shapes]


def coati2_kernel_cases(gen):
    """The four attention kernels at COATI2 grande's shapes (16 heads of
    32): K2 at the encode batch (T 128) and at its prefills (T 3 behind
    [CLIP][UNK][SMILES], T 27 behind the conditioned prefix the path
    decodes from), K1 in every production form at its decode batch over a
    128-wide cache, K5f and K5b at the trainer's doubled views (B 320) and
    its AR pass (B 160), at n_seq and at the widths its batches take (48 to
    80, where the bf16 bodies group 4 or 2 heads a block forward and 1
    backward; 128 groups 1 in both)."""
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [_attention_case("flash_causal_attention", 1024, t, 16, 32, bf16, gen)
             for t in (128, 3, 27)]
    for pos in (3, 36, 95, 127):
        for kv in (bf16, "int8/float32", "int8/bfloat16"):
            cases.append(_decode_case(1024, 128, 16, 32, pos, bf16, kv, gen))
    for t in (128, 48, 64, 80):
        for b in (320, 160):
            cases.append(_attention_case("packed_causal_attention", b, t, 16, 32, bf16, gen))
            cases.append(_attention_bwd_case(b, t, 16, 32, bf16, gen))
    cases.append(_attention_bwd_case(320, 128, 16, 32, f32, gen))
    for case in cases:
        case["model"] = "coati2"
    return cases


# (kernel, B, T, H, Dh, dtype) of every full-sequence attention case held
# against its plain version so far
HELD = set()
ATTENTION_KERNELS = ("flash_causal_attention", "packed_causal_attention",
                     "packed_causal_attention_backward")


def _held(case):
    return (case["kernel"], *case["shape"], case["dtype"])


def hold_path_shapes(phase, shapes):
    """Holds each attention kernel against its plain version, untimed, at
    the (kernel, B, T, H, Dh, dtype) shapes a path ran that phase kernels
    did not hold: the widths of a path's batches come from its data."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    new = sorted(set(shapes) - HELD)
    cases = []
    for name, b, t, h, dh, dtype_name in new:
        dtype = getattr(torch, dtype_name)
        if name == "packed_causal_attention_backward":
            cases.append(_attention_bwd_case(b, t, h, dh, dtype, gen, timed=False))
        else:
            cases.append(_attention_case(name, b, t, h, dh, dtype, gen, timed=False))
    for case in cases:
        emit({"phase": "kernel", "held_for": phase, **case})
    emit({"phase": "path_shapes", "path": phase, "shapes": [list(x) for x in sorted(set(shapes))],
          "held_here": [list(x) for x in new]})
    HELD.update(new)
    check(all(c["ok"] for c in cases), f"{phase}: a kernel case at the path's shapes is "
          "outside tolerance")


def phase_kernels():
    """Every kernel against its plain version; returns the case of each
    kernel at the production shape, for the report."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = attention_cases(gen) + coati2_kernel_cases(gen)
    # K5b: the trainer's batch at its widest and at its real widths, the
    # inference batch at the widths K5f serves, ragged shapes at the other
    # head sizes, and the edges of the bf16 body's 16-row tiles
    for dtype in (bf16, f32):
        cases.append(_attention_bwd_case(160, 80, 16, 16, dtype, gen))
        cases.append(_attention_bwd_case(1024, 96, 16, 16, dtype, gen))
        cases.append(_attention_bwd_case(1024, 128, 16, 16, dtype, gen))
    cases.append(_attention_bwd_case(160, 32, 16, 16, bf16, gen))
    cases.append(_attention_bwd_case(160, 48, 16, 16, bf16, gen))
    cases.append(_attention_bwd_case(5, 17, 4, 32, f32, gen))
    cases.append(_attention_bwd_case(5, 17, 4, 32, bf16, gen))
    cases.append(_attention_bwd_case(2, 70, 2, 64, bf16, gen))
    cases += [_attention_bwd_case(16, t, h, dh, bf16, gen, timed=False)
              for t in (1, 15, 16, 17, 127) for h, dh in ((8, 16), (4, 32), (6, 64))]
    # K3 and K4: ragged molecules with a lone atom and an all-padding row,
    # small odd shapes, then the fixture's molecules (timed; the main paths'
    # shapes: all 1,024 at the document's cutoff for K3, the trainer's batch
    # of 160 at the document's and at the recipe's cutoff for both)
    ragged = [int(x) for x in torch.randint(2, 65, (64,), generator=gen, device="cuda")]
    ragged[:3] = [64, 1, 0]
    for mm in (f32, bf16):
        geometry = _random_geometry(ragged, 64, gen)
        cases.append(_messages_case(*geometry, 256, mm, gen, "ragged"))
        cases.append(_messages_bwd_case(*geometry, 256, mm, gen, "ragged"))
    cases.append(_messages_bwd_case(*_random_geometry([11, 5, 0], 11, gen), 32, f32, gen, "odd"))
    cases.append(_messages_bwd_case(*_random_geometry([11, 7, 3], 11, gen), 128, bf16, gen, "odd"))
    cases.append(_messages_bwd_case(*_random_geometry([9, 130], 130, gen), 20, f32, gen, "odd"))
    # the bf16 body's edges: Hm not a multiple of 16 or 64 (slices of 32 and
    # 64 columns, padded), N not a multiple of 8, an all-padding molecule
    for counts, n, hm in (([11, 5, 0], 11, 20), ([9, 130, 0], 130, 200),
                          ([37, 0, 20, 1], 37, 100), ([13, 2], 13, 136)):
        geometry = _random_geometry(counts, n, gen)
        cases.append(_messages_bwd_case(*geometry, hm, bf16, gen, "odd", timed=False))
    for cutoff, label in ((5.0, "fixture160"), (12.0, "fixture160_cutoff12")):
        d2, w, _ = _fixture_geometry(160, cutoff)
        for mm in (f32, bf16):
            cases.append(_messages_case(d2, w, 256, mm, gen, label))
            cases.append(_messages_bwd_case(d2, w, 256, mm, gen, label))
    cases.append(_messages_case(*_random_geometry([11, 5, 0], 11, gen), 32, f32, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([11, 7, 3], 11, gen), 128, bf16, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([9, 130], 130, gen), 20, f32, gen, "odd"))
    # K3's bf16 body at its edges: Hm not a multiple of 16 or 64 (W2 and e1
    # padded to 64, 128, 192, 256), N not a multiple of 8 and up to 130, a
    # lone atom, an all-padding molecule
    for counts, n, hm in (([11, 5, 0], 11, 20), ([9, 130, 0, 1], 130, 200),
                          ([37, 0, 20, 1], 37, 100), ([13, 2, 1], 13, 136)):
        cases.append(_messages_case(*_random_geometry(counts, n, gen), hm, bf16, gen, "edge",
                                    timed=False))
    cases.append(_messages_refusal_case(gen))
    d2, w, _ = _fixture_geometry()
    for mm in (f32, bf16):
        cases.append(_messages_case(d2, w, 256, mm, gen, "fixture"))
    del d2, w
    # K1: the paths decode from pos 3 (after [CLIP][UNK][SMILES]) to about
    # 15 (SMILES) and 36 (points); 0, 95 and 249 are the cache's edges and
    # middle. Every form at every position, and odd widths and head sizes
    for pos in (0, 3, 15, 36, 95, 249):
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, bf16, gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/float32", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/bfloat16", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, "int8/float32", gen))
        cases.append(_decode_case(64, 250, 16, 16, pos, f32, f32, gen))  # the fp32 round trip's
    cases.append(_decode_case(3, 40, 4, 32, 17, f32, f32, gen))
    for pos in (0, 17, 39):
        for kv in (bf16, "int8/float32", "int8/bfloat16"):
            cases.append(_decode_case(5, 40, 16, 32, pos, bf16, kv, gen))  # COATI2-grande's Dh
        cases.append(_decode_case(3, 40, 6, 16, pos, f32, f32, gen))  # H not a power of two
        cases.append(_decode_case(3, 40, 6, 16, pos, bf16, "int8/float32", gen))
        cases.append(_decode_case(2, 40, 64, 16, pos, f32, "int8/float32", gen))  # H 64
    for case in cases:
        emit({"phase": "kernel", **case})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"{len(bad)} kernel case(s) outside tolerance")
    HELD.update(_held(c) for c in cases if c["kernel"] in ATTENTION_KERNELS)
    pick = {  # the case of each wrapper that the report's line carries
        "flash_causal_attention": {"shape": [1024, 250, 16, 16], "dtype": "bfloat16"},
        "decode_attention": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16", "pos": 95},
        "decode_attention_quant": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16",
                                   "pos": 95},
        # the production mode: the points path and the trainer run bf16
        "egnn_messages": {"case": "fixture", "mm_dtype": "bfloat16"},
        "packed_causal_attention": {"shape": [1024, 96, 16, 16], "dtype": "bfloat16"},
        # the trainer's shapes: bf16, batch 160, the recipe's cutoff
        "egnn_messages_backward": {"case": "fixture160_cutoff12", "mm_dtype": "bfloat16"},
        "packed_causal_attention_backward": {"shape": [160, 80, 16, 16], "dtype": "bfloat16"},
    }
    chosen = {}
    for c in cases:
        if all(c.get(key) == value for key, value in pick[c["kernel"]].items()):
            chosen.setdefault(c["kernel"], c)
    return chosen


def phase_routing():
    """Routing numbers, no routing change: forward and backward of the
    trainer's attention at its widths (B 160, H 16, Dh 16, bf16, strided q,
    k, v of one fused projection, as the model passes them) through the
    packed pair (K5f + K5b), which the trainer takes at n_seq <= 128, and
    through K2 with its replayed plain backward. Each is the device time of
    one forward and one torch.autograd.grad, between CUDA events."""
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, dh = 160, 16, 16
    for t in (48, 80):
        qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(torch.bfloat16)
        qkv.requires_grad_(True)
        g = torch.randn(b, t, h, dh, generator=gen, device="cuda").to(torch.bfloat16)

        def fwd_bwd(kernel):
            q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
            return torch.autograd.grad(kernel(q, k, v), (qkv,), g)

        # a spin of about 5 ms: autograd's host work for one forward and
        # backward is enqueued before the card starts on it
        row = {"phase": "routing", "shape": [b, t, h, dh], "dtype": "bfloat16",
               "packed_k5f_k5b_ms": time_ms(lambda: fwd_bwd(packed_causal_attention),
                                            spin=10_000_000),
               "flash_k2_replayed_ms": time_ms(lambda: fwd_bwd(flash_causal_attention),
                                               spin=10_000_000)}
        row["packed_over_flash"] = row["packed_k5f_k5b_ms"] / row["flash_k2_replayed_ms"]
        emit(row)


@contextlib.contextmanager
def plain_versions():
    """Route the model to the kernels' plain versions, for comparison:
    swaps the kernel wrappers that the transformer and EGNN modules call.
    The plain forwards are plain tensor code, so a backward through them is
    PyTorch's own autograd and reaches neither K4, K5b nor K2's replay."""
    from coati_tpu_torch.models import egnn, transformer
    from coati_tpu_torch.ops import attention as plain
    from coati_tpu_torch.ops import egnn_messages as plain_messages

    def causal(q, k, v):
        return plain.causal_attention(q, k, v, torch.float32)

    swaps = [
        (transformer, "flash_causal_attention", causal),
        (transformer, "packed_causal_attention", causal),
        (transformer, "decode_attention", plain.decode_attention),
        (transformer, "decode_attention_quant", plain.decode_attention_quant),
        (egnn, "egnn_messages", plain_messages.egnn_messages),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in swaps]
    for module, name, fn in swaps:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def _wrappers():
    from coati_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_quant
    from coati_tpu_torch.ops.kernels.egnn_messages import egnn_messages
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention
    from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention

    return {w.__name__: w for w in (flash_causal_attention, decode_attention,
                                    decode_attention_quant, egnn_messages,
                                    packed_causal_attention)}


# the backward kernels count on the forward wrapper they belong to
BACKWARD_OF = {"egnn_messages_backward": "egnn_messages",
               "packed_causal_attention_backward": "packed_causal_attention"}


def _counts():
    wrappers = _wrappers()
    counts = {name: w.launches for name, w in wrappers.items()}
    counts.update({name: wrappers[fwd].bwd_launches for name, fwd in BACKWARD_OF.items()})
    return counts


def _zero_counts():
    for w in _wrappers().values():
        w.launches = 0
    for fwd in BACKWARD_OF.values():
        _wrappers()[fwd].bwd_launches = 0


def _tokens(tok, smiles, width):
    """(B, width) '[SMILES]...[STOP]' rows padded with the vocabulary's
    [PAD] (0 in COATI's, 31 in COATI2's)."""
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.full((len(rows), width), tok.pad_token, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _timed(fn):
    """(fn(), seconds on the host clock with the card drained before and
    after, launches of each kernel in the call)."""
    before = _counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return out, seconds, {n: c - before[n] for n, c in _counts().items()}


def _round_trip(model, tok, tokens, **kw):
    """One timed round trip; returns (smiles, hclip, seconds, launches)."""
    (smiles, h), seconds, launches = _timed(
        lambda: model.smiles_to_2d_batch(tokens, tok, return_embeddings=True, **kw)
    )
    return smiles, h, seconds, launches


def host_cpu() -> dict:
    """The host CPU's vendor and model (/proc/cpuinfo) and core count: the
    host numbers of phases chem, points_from_smiles and host_pipeline are
    taken on it."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return {"phase": "host", "cpu_vendor": info.get("vendor_id", "not reported"),
            "cpu_model": info.get("model name", "not reported"), "cores": os.cpu_count()}


def phase_chem():
    """The chemistry core on the host: the native libraries must build and
    load (a GPU host has a C compiler, and a silent fall back to Python
    would hide the path), the canonicalizer over the whole corpus, and its
    native path, permutations and the native matcher on a seeded sample."""
    from coati_tpu_torch import native
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.chem.selfies_lite import permute_smiles
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.matcher import VocabMatcher

    start = time.perf_counter()
    canon_lib, matcher_lib = native.load_fast_canon(), native.load_fast_matcher()
    build_s = time.perf_counter() - start
    check(canon_lib is not None and matcher_lib is not None,
          f"chem: the native libraries did not build or load: {native.BUILD_ERRORS}")
    corpus = gzip.open(CORPUS, "rt").read().split()
    distinct = len(set(corpus))

    graph_canon._canonical_cached.cache_clear()
    before = dict(native.CANON_PATHS)
    start = time.perf_counter()
    canonical = [graph_canon.canonical_smiles(s) for s in corpus]
    cold_s = time.perf_counter() - start
    paths = {k: native.CANON_PATHS[k] - before[k] for k in before}
    check(sum(paths.values()) == distinct, f"chem: {paths} canonicalizations of {distinct} lines")
    start = time.perf_counter()
    check([graph_canon.canonical_smiles(s) for s in corpus] == canonical, "chem: a warm pass differs")
    warm_s = time.perf_counter() - start

    sample = random.Random(0).sample(corpus, 2000)
    start = time.perf_counter()
    by_python = [graph_canon._canonical_python(s, True, 512) for s in sample]
    python_s = time.perf_counter() - start
    start = time.perf_counter()
    by_native = [graph_canon._try_native(s, True, 512) for s in sample]
    native_s = time.perf_counter() - start
    differ = sum(a != b for a, b in zip(by_native, by_python))
    check(differ == 0, f"chem: the native path differs from the Python path on {differ} of 2000")
    rng = random.Random(1)
    permuted = [permute_smiles(s, rng) for s in sample]
    moved = sum(p != s for p, s in zip(permuted, sample))
    wrong = sum(graph_canon.canonical_smiles(p) != graph_canon.canonical_smiles(s)
                for p, s in zip(permuted, sample))
    check(wrong == 0, f"chem: {wrong} of 2000 permuted writings canonicalize to another string")

    vocab = get_vocab("mar")
    tokens = list(vocab["special_tokens"]) + list(vocab["smiles_tokens"])
    fast = VocabMatcher(tokens)
    check(fast.uses_native, "chem: the native matcher is not in use")
    texts = ["[SMILES]" + s + "[STOP]" for s in sample + permuted]
    start = time.perf_counter()
    splits = [fast.split(t) for t in texts]
    fast_s = time.perf_counter() - start
    start = time.perf_counter()
    differ = sum(a != fast._split_python(t) for a, t in zip(splits, texts))
    scan_s = time.perf_counter() - start
    check(differ == 0, f"chem: the native matcher splits {differ} of {len(texts)} texts otherwise")
    emit({"phase": "chem", "native_build_and_load_s": build_s,
          "corpus_lines": len(corpus), "corpus_distinct": distinct,
          "canonicalize_cold_s": cold_s, "canonicalize_cold_mol_per_s": len(corpus) / cold_s,
          "canonicalize_warm_s": warm_s, "canonicalize_warm_mol_per_s": len(corpus) / warm_s,
          "answered_by": paths, "fixed_points": sum(a == b for a, b in zip(canonical, corpus)),
          "sample": len(sample), "native_equals_python": True,
          "sample_native_s": native_s, "sample_python_s": python_s,
          "permuted_writings_moved": moved, "permuted_canonicalize_back": True,
          "matcher_texts": len(texts), "matcher_native_s": fast_s, "matcher_python_s": scan_s})


def load_model():
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    start = time.perf_counter()
    model, tok = load_e3gnn_smiles_clip_e2e(str(DOC))  # no device: the card
    check(model.device.type == "cuda", f"model loaded on {model.device}, not the card")
    cfg = model.config
    emit({"phase": "load", "doc": DOC.name, "seconds": time.perf_counter() - start,
          "n_layer": cfg.n_layer_xformer, "n_embd": cfg.n_hidden_xformer,
          "n_head": cfg.n_head, "n_seq": cfg.n_seq, "n_tok": tok.n_token,
          "egnn_layers": cfg.n_layer_e3gnn, "egnn_hidden": cfg.n_hidden_e3nn,
          "egnn_cutoff": cfg.egnn_config.message_cutoff})
    return model, tok


def phase_smiles(model, tok):
    """The first main path: SMILES -> embedding -> SMILES on the card.
    Returns (launch counts of the path, the total_len 96 production run)."""
    from coati_tpu_torch.models.api import COATI

    n_layer = model.config.n_layer_xformer

    # (a) fp32 greedy: kernels against plain versions, 64 corpus SMILES
    corpus = gzip.open(CORPUS, "rt").read().split()
    picks = [corpus[i] for i in np.random.default_rng(0).permutation(len(corpus))[:64]]
    tokens = _tokens(tok, picks, tok.n_seq)
    with plain_versions():
        plain_smiles, plain_h, _, plain_launches = _round_trip(model, tok, tokens, k=1)
    check(sum(plain_launches.values()) == 0, "the plain run launched a kernel")

    _zero_counts()  # the path starts here
    smiles, h, seconds, launches = _round_trip(model, tok, tokens, k=1)
    agree = sum(a == b for a, b in zip(smiles, plain_smiles))
    emit({"phase": "fp32_greedy", "rows": len(picks), "agree_with_plain": agree,
          "hclip_max_abs_diff": float(np.abs(h - plain_h).max()),
          "exact_round_trips": sum(a == b for a, b in zip(smiles, picks)),
          "seconds": seconds, "launches": launches})
    check(agree >= 63, f"fp32 greedy: only {agree}/64 rows agree with the plain versions")
    check(launches["flash_causal_attention"] == 2 * n_layer,
          "fp32: flash kernel not launched once per layer for the encode and the prefill")
    check(launches["decode_attention"] > 0 and launches["decode_attention"] % n_layer == 0,
          "fp32: decode kernel not launched once per layer per step")

    # (b) production: bf16, int8 KV cache (kv_dtype "auto"), batch 1024
    prod = COATI(model.params, model.config.replace(dtype="bfloat16"), seed=0)
    check(prod.config.xformer_config.kv_quantized, "bf16 config does not quantize the cache")
    _production(prod, tok, "n_seq_250", None, "flash_causal_attention")
    short = _production(prod, tok, "total_len_96", 96, "flash_causal_attention")
    return _counts(), short


def _production(prod, tok, label, total_len, full_kernel):
    """The production round trip of bench.py's SMILES at batch 1024: one
    warm-up and three timed runs, the encode alone, one traced run. Every
    full-sequence attention must go through `full_kernel`, the other of K2
    and K5f must not run, and every decode step through the int8 K1."""
    n_layer = prod.config.n_layer_xformer
    other = ({"flash_causal_attention", "packed_causal_attention"} - {full_kernel}).pop()
    bench = (BENCH_SMILES * 64)[:1024]
    width = total_len or tok.n_seq
    tokens = _tokens(tok, bench, width)
    kw = dict(k=100, inv_temp=2.0, total_len=total_len)
    runs = [_round_trip(prod, tok, tokens, **kw) for _ in range(4)]  # the first is warm-up
    for out, _, _, run_launches in runs:
        check(len(out) == 1024 and all(isinstance(s, str) for s in out), "rows not decoded")
        check(run_launches[full_kernel] == 2 * n_layer and run_launches[other] == 0,
              f"{label}: full-sequence kernel counts {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"{label}: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[2] for r in runs[1:])
    out = runs[-1][0]
    encode_s = statistics.median(
        _timed(lambda: prod.encode_tokens(tokens, tok))[1] for _ in range(3)
    )
    result = {"phase": "production", "shape": label, "batch": 1024, "dtype": "bfloat16",
              "prefill_kernel": prod.config.prefill_kernel,
              "kv": "int8/float32", "k": 100, "inv_temp": 2.0, "encode_T": width,
              "mol_per_s": 1024 / seconds, "seconds": seconds,
              "seconds_all": [r[2] for r in runs], "encode_seconds": encode_s,
              "decode_steps": runs[-1][3]["decode_attention_quant"] // n_layer,
              "launches_per_round_trip": runs[-1][3],
              "exact_round_trips": sum(a == b for a, b in zip(out, bench)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(result)
    DECODE_RUNS.append((label, width, result["decode_steps"]))
    _profile(lambda: prod.smiles_to_2d_batch(tokens, tok, **kw), label, seconds)
    return result


def phase_points(model, tok):
    """The second main path: 3D point clouds -> embedding -> SMILES, on the
    1,024 molecules of the fixture (N 128 with hydrogens), EGNN at the
    document's 5 layers x 256. Returns the launch counts of the path."""
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.egnn import egnn_forward

    cfg = model.config
    n_egnn, n_layer = cfg.n_layer_e3gnn, cfg.n_layer_xformer
    smiles, atoms, coords = load_points_fixture()
    check(atoms.shape[0] == 1024, f"fixture has {atoms.shape[0]} rows, not 1024")
    atoms_t = torch.as_tensor(atoms.astype(np.int64), device="cuda")
    coords_t = torch.as_tensor(coords, device="cuda")

    # comparisons first, outside the counted window: the plain version of
    # the message kernel, and the SMILES embeddings of the same molecules
    with plain_versions(), torch.no_grad():
        (plain_pool, plain_h), plain_s, plain_launches = _timed(lambda: (
            egnn_forward(model.params.point_encoder, cfg.egnn_config, atoms_t, coords_t),
            model.encode_points(atoms, coords),
        ))
    check(sum(plain_launches.values()) == 0, "the plain run launched a kernel")
    h_smiles = model.encode_tokens(_tokens(tok, smiles, tok.n_seq), tok)

    _zero_counts()  # the path starts here
    with torch.no_grad():
        pool = egnn_forward(model.params.point_encoder, cfg.egnn_config, atoms_t, coords_t)
    runs = [_timed(lambda: model.encode_points(atoms, coords)) for _ in range(4)]
    h = runs[-1][0]
    for _, _, run_launches in runs:
        check(run_launches["egnn_messages"] == n_egnn and sum(run_launches.values()) == n_egnn,
              f"encode_points: kernel counts {run_launches}")
    pool_diff = float((pool - plain_pool).abs().max())
    check(tuple(h.shape) == (1024, cfg.embed_dim) and bool(torch.isfinite(h).all()),
          "encode_points: embeddings not finite or of the wrong shape")
    # the pooled EGNN output, before the projection's LayerNorm rescales it:
    # float32 through the kernel and through its plain version differ by
    # the order of sums only, five layers deep
    check(pool_diff <= 1e-4, f"EGNN through K3 and through the plain version differ by {pool_diff}")
    cos = torch.nn.functional.cosine_similarity(h, h_smiles, dim=-1)
    shuffled = torch.nn.functional.cosine_similarity(h, h_smiles.roll(1, dims=0), dim=-1)
    quantiles = torch.quantile(cos, torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0], device="cuda"))
    emit({"phase": "points_fp32", "rows": 1024, "atoms_max": int(atoms.shape[1]),
          "atoms_per_molecule_mean": float((atoms > 0).sum(1).mean()),
          "egnn_pooled_max_abs_diff_vs_plain": pool_diff,
          "hclip_max_abs_diff_vs_plain": float((h - plain_h).abs().max()),
          "encode_points_seconds_all": [r[1] for r in runs],
          "encode_points_seconds": statistics.median(r[1] for r in runs[1:]),
          "plain_egnn_and_encode_seconds": plain_s,
          "cosine_point_vs_smiles": {
              "min_p5_median_p95_max": [float(x) for x in quantiles],
              "mean": float(cos.mean()), "mean_shuffled_pairs": float(shuffled.mean())},
          "launches_per_encode": runs[-1][2]})
    check(float(cos.mean()) > float(shuffled.mean()),
          "point embeddings are no closer to their own SMILES embeddings than to others'")

    # production: bf16 (bf16 inner product in K3), int8 KV cache, k 100
    prod = COATI(model.params, cfg.replace(dtype="bfloat16"), seed=0)
    kw = dict(k=100, inv_temp=2.0)
    runs = [_timed(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw))
            for _ in range(4)]  # the first is warm-up
    for out, _, run_launches in runs:
        check(len(out) == 1024 and all(isinstance(s, str) for s in out), "rows not decoded")
        check(run_launches["egnn_messages"] == n_egnn, f"points: K3 count {run_launches}")
        check(run_launches["flash_causal_attention"] == n_layer,
              f"points: the prefill's flash kernel count {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"points: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[1] for r in runs[1:])
    out = runs[-1][0]
    encode_s = [_timed(lambda: prod.encode_points(atoms, coords))[1] for _ in range(3)]
    h_bf16 = prod.encode_points(atoms, coords).float()
    emit({"phase": "points_production", "batch": 1024, "dtype": "bfloat16",
          "kv": "int8/float32", "k": 100, "inv_temp": 2.0,
          "mol_per_s": 1024 / seconds, "seconds": seconds,
          "seconds_all": [r[1] for r in runs],
          "encode_points_seconds": statistics.median(encode_s),
          "encode_points_seconds_all": encode_s,
          "cosine_bf16_vs_fp32_mean": float(
              torch.nn.functional.cosine_similarity(h_bf16, h, dim=-1).mean()),
          "decode_steps": runs[-1][2]["decode_attention_quant"] // n_layer,
          "launches_per_call": runs[-1][2],
          "exact_recoveries": sum(a == b for a, b in zip(out, smiles)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    DECODE_RUNS.append(("points", tok.n_seq, runs[-1][2]["decode_attention_quant"] // n_layer))
    _profile(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw), "points", seconds)
    _profile(lambda: prod.encode_points(atoms, coords), "encode_points",
             statistics.median(encode_s))
    return _counts()


def phase_points_from_smiles(model, tok):
    """SMILES -> the port's own conformers -> points_to_2d_batch: the
    fixture's 1,024 SMILES embedded on the host by chem/conformers.py, held
    against the fixture coati_tpu wrote, then decoded in the production
    setting. Returns the launch counts of the path."""
    from coati_tpu_torch.chem.conformers import embed_smiles_to_atoms_coords
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.api import COATI

    cfg = model.config
    n_egnn, n_layer = cfg.n_layer_e3gnn, cfg.n_layer_xformer
    smiles, f_atoms, f_coords = load_points_fixture()
    start = time.perf_counter()
    embedded = [embed_smiles_to_atoms_coords(s) for s in smiles]
    embed_s = time.perf_counter() - start
    atoms, coords = np.zeros_like(f_atoms), np.zeros_like(f_coords)
    same_atoms = close = 0
    worst_dist = worst_xyz = 0.0
    worst_row = -1
    for i, (a, c) in enumerate(embedded):
        n = len(a)
        check(n <= atoms.shape[1] and np.isfinite(c).all(), f"points_from_smiles: row {i}")
        atoms[i, :n], coords[i, :n] = a, c
        same_atoms += bool(np.array_equal(atoms[i], f_atoms[i]))
        mine = np.linalg.norm(c[:, None] - c[None], axis=-1)
        ref = f_coords[i, :n].astype(np.float64)
        err = float(np.abs(mine - np.linalg.norm(ref[:, None] - ref[None], axis=-1)).max())
        close += err <= 1e-3
        if err > worst_dist:
            worst_dist, worst_row = err, i
        worst_xyz = max(worst_xyz, float(np.abs(c - ref).max()))
    rows = len(smiles)
    emit({"phase": "points_from_smiles_embed", "rows": rows,
          "embed_seconds": embed_s, "mol_per_s": rows / embed_s,
          "rows_with_the_fixture_s_atoms": same_atoms,
          "rows_with_distances_within_1e-3": close,
          "max_distance_diff_angstrom": worst_dist, "max_distance_diff_row": worst_row,
          "max_coordinate_diff_angstrom": worst_xyz})
    check(same_atoms == rows, f"points_from_smiles: atoms differ from the fixture's in "
                              f"{rows - same_atoms} rows")
    check(worst_dist <= 1e-4, f"points_from_smiles: distances differ from the fixture's by "
                              f"{worst_dist} A in row {worst_row} (tolerance 1e-4)")

    prod = COATI(model.params, cfg.replace(dtype="bfloat16"), seed=0)
    kw = dict(k=100, inv_temp=2.0)
    _zero_counts()  # the path starts here
    runs = [_timed(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw))
            for _ in range(2)]  # the first is warm-up
    counts = _counts()  # and ends here
    for out, _, run_launches in runs:
        check(len(out) == rows and all(isinstance(s, str) for s in out),
              "points_from_smiles: rows not decoded")
        check(run_launches["egnn_messages"] == n_egnn, f"points_from_smiles: K3 {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"points_from_smiles: int8 K1 {run_launches}")
    out, seconds, launches = runs[-1]
    emit({"phase": "points_from_smiles", "batch": rows, "dtype": "bfloat16",
          "kv": "int8/float32", "k": 100, "inv_temp": 2.0, "seconds": seconds,
          "seconds_all": [r[1] for r in runs], "mol_per_s": rows / seconds,
          "decode_steps": launches["decode_attention_quant"] // n_layer,
          "launches_per_call": launches,
          "exact_recoveries": sum(a == b for a, b in zip(out, smiles))})
    return counts


def phase_packed(model, tok, flash_run):
    """The total_len 96 production round trip again under
    prefill_kernel="packed": K5f in place of K2. Returns the launch counts."""
    from coati_tpu_torch.models.api import COATI

    # comparison first, outside the counted window: fp32 embeddings under
    # K5f against those under K2 (the order of sums only)
    tokens = _tokens(tok, (BENCH_SMILES * 64)[:1024], 96)
    packed32 = COATI(model.params, model.config.replace(prefill_kernel="packed"), seed=0)
    diff = float((packed32.encode_tokens(tokens, tok) - model.encode_tokens(tokens, tok)).abs().max())
    check(diff <= 1e-5, f"fp32 embeddings under K5f and under K2 differ by {diff}")

    _zero_counts()  # the path starts here
    prod = COATI(model.params,
                 model.config.replace(dtype="bfloat16", prefill_kernel="packed"), seed=0)
    run = _production(prod, tok, "total_len_96_packed", 96, "packed_causal_attention")
    emit({"phase": "packed_vs_flash", "shape": "total_len_96",
          "fp32_hclip_max_abs_diff": diff,
          "encode_seconds": {"packed": run["encode_seconds"], "flash": flash_run["encode_seconds"]},
          "round_trip_seconds": {"packed": run["seconds"], "flash": flash_run["seconds"]}})
    return _counts()


# (path, cache width, decode steps) of each production round trip: a step
# at position p launches K1 once a layer, from p = 3 after the prefix
# [CLIP][UNK][SMILES]
DECODE_RUNS = []
PREFIX_LEN = 3


def phase_k1_positions(n_layer):
    """K1's int8 form (bf16 query, float32 scales; B 1024, H 16, Dh 16) timed
    at every position each production round trip decoded, and its time in
    each call weighted by those launches, beside its bound and beside the
    same launches priced at pos 95. Runs after the paths' windows: these
    launches are not the paths'."""
    from coati_tpu_torch.models.transformer import quantize_kv
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, dh = 1024, 16, 16
    q = torch.randn(b, h, dh, generator=gen, device="cuda").to(torch.bfloat16)
    caches, times = {}, {}

    def ms(width, pos):
        if width not in caches:
            kv = torch.randn(2, b, width, h, dh, generator=gen, device="cuda")
            caches[width] = (*quantize_kv(kv[0]), *quantize_kv(kv[1]))
        if (width, pos) not in times:
            k8, ks, v8, vs = caches[width]
            times[width, pos] = time_ms(lambda: k1.decode_attention_quant(q, k8, ks, v8, vs, pos))
        return times[width, pos]

    def bound(pos):
        live = pos + 1
        return bound_ms(2 * b * h * dh * 2 + live * b * h * (2 * dh + 2 * 4),
                        4 * b * h * live * dh, torch.float32)[0]

    for label, width, steps in DECODE_RUNS:
        positions = range(PREFIX_LEN, PREFIX_LEN + steps)
        total = n_layer * sum(ms(width, p) for p in positions)
        emit({"phase": "k1_positions", "path": label, "cache_width": width,
              "positions": [positions[0], positions[-1]], "launches": n_layer * steps,
              "ms_by_position": {p: ms(width, p) for p in positions},
              "k1_ms_per_call": total, "k1_ms_per_launch": total / (n_layer * steps),
              "bound_ms_per_call": n_layer * sum(bound(p) for p in positions),
              "priced_at_pos95_ms": n_layer * steps * ms(width, 95)})


class _StampedDataset:
    """A training dataset that notes the host clock each time the trainer
    takes a batch, and keeps the transformed batches and the seconds the
    trainer's transform took on each. With the trainer's deferred metric
    reads, the time between two takes is one whole step in steady state:
    the wait for the step before, this step's launches, and the next
    batch's host transform."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.summary = dataset.summary
        self.stamps, self.batches, self.xform_s = [], [], []
        self.pipe_kw = {}

    def get_data_pipe(self, xform_routine=lambda b: b, **kw):
        self.pipe_kw = kw

        def timed(batch):
            start = time.perf_counter()
            out = xform_routine(batch)
            self.xform_s.append(time.perf_counter() - start)
            return out

        for batch in self.dataset.get_data_pipe(xform_routine=timed, **kw):
            self.stamps.append(time.perf_counter())
            self.batches.append(batch)
            yield batch

    def raw_batches(self, n):
        """The first n raw batches of the last pipe again, untransformed:
        the pipe is seeded, so they are the ones the trainer took."""
        return list(itertools.islice(self.dataset.get_data_pipe(**self.pipe_kw), n))


def _host_pipeline(config, data, steps, step_s, canon_in_run):
    """The trainer's transform replayed on the raw batches of the counted
    run, after it: cold (the canonical-SMILES and conformer caches cleared
    before each batch) and warm, beside the step; the share of targets that
    were permuted; the canonicalizations each path answered."""
    import statistics as st

    from coati_tpu_torch import native
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self
    from coati_tpu_torch.data import xform
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    tok = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))

    def replay(raw):
        batch = {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in raw.items()}
        start = time.perf_counter()
        xform.clip_ar_xform(batch, tokenizer=tok, p_dataset=config.p_dataset,
                            p_formula=config.p_formula, p_fim=config.p_fim,
                            p_graph=config.p_graph, p_clip=config.p_clip,
                            p_clip_cut=config.p_clip_cut, p_randsmiles=config.p_randsmiles)
        return time.perf_counter() - start

    raws = data.raw_batches(steps)
    check(all(list(r["smiles"]) == list(b["smiles"]) for r, b in zip(raws, data.batches)),
          "host_pipeline: the replayed raw batches are not the run's")
    before = dict(native.CANON_PATHS)
    cold = []
    for raw in raws:
        graph_canon._canonical_cached.cache_clear()
        xform._embed_conformer_cached.cache_clear()
        cold.append(replay(raw))
    canon_cold = {k: native.CANON_PATHS[k] - before[k] for k in before}
    warm = [replay(raw) for raw in raws]
    rows = permuted = 0
    for batch in data.batches[:steps]:
        for smiles, target in zip(batch["smiles"], batch["raw_tokens"]):
            plain = tok.tokenize_text("[SMILES]" + canonicalize_or_self(str(smiles)) + "[STOP]",
                                      pad=False)
            rows += 1
            permuted += list(target[target > 0]) != plain
    in_run = st.median(data.xform_s[:steps])
    out = {"phase": "host_pipeline", "batch": config.batch_size,
           "batches": len(raws), "p_randsmiles": config.p_randsmiles,
           "permuted_target_share": permuted / rows,
           "xform_in_run_s": in_run, "xform_in_run_s_all": data.xform_s[:steps],
           "xform_cold_s": st.median(cold), "xform_cold_s_all": cold,
           "xform_warm_s": st.median(warm), "xform_warm_s_all": warm,
           "step_seconds": step_s, "in_run_share_of_step": in_run / step_s,
           "cold_share_of_step": st.median(cold) / step_s,
           "warm_share_of_step": st.median(warm) / step_s,
           "canonicalized_in_run_by": canon_in_run, "canonicalized_cold_replay_by": canon_cold}
    emit(out)
    check(canon_in_run["python"] == 0 and canon_in_run["native"] > 0,
          f"train: canonicalizations in the run {canon_in_run}")
    check(0 < permuted < rows, f"train: {permuted} of {rows} targets permuted")
    return out


def _train_step(config, model):
    """(the trainer's step over `model` with a new optimizer, tokenizer)."""
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
    from coati_tpu_torch.training import train

    tok = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))
    model_cfg = train.model_config_from_train_config(config, tok.n_token)
    if model is None:
        model = train.fresh_model(model_cfg, torch.device("cuda"), seed=0)
    step = train.make_train_step(
        model, model_cfg, train.make_optimizer(config, model),
        stop_token=tok.stop_token, unk_token=tok.unk_token,
        p_clip_emb_smi=config.p_clip_emb_smi,
        token_entropy_unit=float(np.log2(tok.n_token)), do_clip=config.do_clip,
    )
    return step, tok


def phase_train():
    """The training path: train_autoencoder with the grande recipe on the
    card. Returns the launch counts of the path."""
    from coati_tpu_torch import native
    from coati_tpu_torch.chem import graph_canon
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    warm, timed = 3, 20
    steps = warm + timed
    # the recipe in bf16 as it is written: every row canonicalized, 30% of
    # the targets permuted
    config = grande_config(dtype="bfloat16", n_epochs=1)
    check(config.p_randsmiles == 0.3, f"train: p_randsmiles {config.p_randsmiles}")
    # one batch more than is trained on: the loop takes it before it stops
    data = _StampedDataset(fixture_dataset((steps + 1) * config.batch_size))
    torch.cuda.reset_peak_memory_stats()
    graph_canon._canonical_cached.cache_clear()  # the run starts cold, as a user's does
    canon_before = dict(native.CANON_PATHS)
    random.seed(0)  # permute_smiles draws from the global random module
    _zero_counts()  # the path starts here
    start = time.perf_counter()
    model, results = train.train_autoencoder(config, data, max_steps_per_epoch=steps, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    counts = _counts()  # and ends here
    canon_in_run = {k: native.CANON_PATHS[k] - canon_before[k] for k in canon_before}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    history = results["history"]
    check(len(history) == steps and all(h[0] == "train" for h in history),
          f"train: {len(history)} steps in the history, not {steps}")
    check(next(model.parameters()).device.type == "cuda", "train: the model is not on the card")
    losses = np.array([h[3:] for h in history], np.float64)  # loss, ar_loss, clip_loss
    check(bool(np.isfinite(losses).all()), "train: a loss is not finite")
    check(losses[-1, 1] < losses[0, 1],
          f"train: ar_loss went from {losses[0, 1]} to {losses[-1, 1]}")
    per_step = {name: c / steps for name, c in counts.items()}
    n_x, n_e = config.n_layer_xformer, config.n_layer_e3gnn
    # encode and decoder trunk, each recomputed once under xformer_remat;
    # the EGNN is not rematerialized
    expected = {"packed_causal_attention": 4 * n_x, "packed_causal_attention_backward": 2 * n_x,
                "egnn_messages": n_e, "egnn_messages_backward": n_e,
                "flash_causal_attention": 0, "decode_attention": 0, "decode_attention_quant": 0}
    check(per_step == expected, f"train: launches a step {per_step}, expected {expected}")
    intervals = np.diff(data.stamps)[warm:]
    check(len(intervals) == timed, f"train: {len(intervals)} timed steps, not {timed}")
    step_s = float(np.median(intervals))
    widths = sorted({(b["tokens"].shape[1], b["raw_tokens"].shape[1], b["atoms"].shape[1])
                     for b in data.batches[:steps]})
    emit({"phase": "train", "recipe": "grande", "dtype": config.dtype,
          "batch": config.batch_size, "n_seq": config.n_seq,
          "xformer": [n_x, config.n_hidden_xformer, config.n_head],
          "egnn": [n_e, config.n_hidden_e3nn, config.msg_cutoff_e3nn],
          "xformer_remat": config.xformer_remat, "egnn_remat": config.egnn_remat,
          "p_randsmiles": config.p_randsmiles, "canonicalize": True,
          "parameters": sum(p.numel() for p in model.parameters()),
          "warmup_steps": warm, "timed_steps": timed,
          "step_seconds": step_s, "step_seconds_all": [float(x) for x in np.diff(data.stamps)],
          "mol_per_s": config.batch_size / step_s,
          "trainer_step_seconds_all": results["train_step_seconds"],
          "train_autoencoder_seconds": total_s,
          "batch_widths_tokens_raw_atoms": widths,
          "loss_first_last": [losses[0, 0], losses[-1, 0]],
          "ar_loss_first_last": [losses[0, 1], losses[-1, 1]],
          "clip_loss_first_last": [losses[0, 2], losses[-1, 2]],
          "ar_loss_all": [float(x) for x in losses[:, 1]],
          "launches_per_step": per_step, "peak_mem_gb": peak_gb})
    _host_pipeline(config, data, steps, step_s, canon_in_run)

    # the split of a step, outside the counted window: the same model and
    # the last batches again, each part between two CUDA events
    step, _ = _train_step(config, model)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = [train.batch_to_device(b, torch.device("cuda")) for b in data.batches[-6:]]
    parts, host_parts = [], []
    for batch in batches:  # the first is warm-up: it makes the optimizer's state
        torch.cuda.synchronize()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        host = [time.perf_counter()]
        marks[0].record()
        loss, _, _ = step.losses(gen, batch)
        marks[1].record()
        host.append(time.perf_counter())
        loss.backward()
        marks[2].record()
        host.append(time.perf_counter())
        step.update()
        marks[3].record()
        host.append(time.perf_counter())
        torch.cuda.synchronize()
        parts.append([a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])])
        host_parts.append([b - a for a, b in zip(host, host[1:])])
    fwd, bwd, opt = (float(x) for x in np.median(np.array(parts[1:]), axis=0))
    # between the events the card also waits for the host; host_launch_s is
    # the time the host took to launch each part, without waiting for the card
    emit({"phase": "train_split", "steps": len(parts) - 1,
          "forward_s": fwd, "backward_s": bwd, "optimizer_s": opt,
          "shares": {"forward": fwd / (fwd + bwd + opt), "backward": bwd / (fwd + bwd + opt),
                     "optimizer": opt / (fwd + bwd + opt)},
          "host_launch_s": [float(x) for x in np.median(np.array(host_parts[1:]), axis=0)],
          "seconds_all": parts})
    _profile(lambda: [step(gen, b) for b in batches[1:4]], "train_step_x3", 3 * step_s, top=24)
    return counts


def _step_gradients(config, batch, pick, plain: bool):
    """(loss, {parameter name: gradient}, launch counts) of one training
    step's backward from a fresh seeded model, through the kernels or, with
    `plain`, through their plain versions."""
    step, _ = _train_step(config, None)
    _zero_counts()
    with plain_versions() if plain else contextlib.nullcontext():
        loss, _, _ = step.losses(None, batch, pick_point=pick)
        loss.backward()
    torch.cuda.synchronize()
    named = list(step.model.named_parameters())
    # the EGNN's coordinate MLPs are in the state dict and in no forward
    unused = [name for name, p in named if p.grad is None]
    check(all(".coord_mlp." in name for name in unused), f"no gradient for {unused}")
    grads = {name: p.grad for name, p in named if p.grad is not None}
    return float(loss.detach()), grads, _counts()


def phase_train_fp32_vs_plain():
    """One float32 training step through the kernels against the same step
    through their plain versions: the packed route (K5f, K5b, K3, K4) at the
    recipe's n_seq, and the flash route (K2 and its replayed backward) at
    T 200."""
    from coati_tpu_torch.data import fixture_dataset
    from coati_tpu_torch.data.xform import clip_ar_xform
    from coati_tpu_torch.training import train
    from coati_tpu_torch.training.config import grande_config

    def one(label, batch_size, n_seq, pad_to):
        config = grande_config(dtype="float32", n_layer_xformer=4, n_layer_e3gnn=2,
                               batch_size=batch_size, n_seq=n_seq)
        _, tok = _train_step(config, None)
        random.seed(0)  # permute_smiles draws from the global random module
        pipe = fixture_dataset(batch_size).get_data_pipe(
            batch_size=batch_size,
            xform_routine=lambda b: clip_ar_xform(
                b, tokenizer=tok, p_dataset=config.p_dataset, p_formula=config.p_formula,
                p_clip=config.p_clip, p_clip_cut=config.p_clip_cut,
                p_randsmiles=config.p_randsmiles, rng=random.Random(0)))
        host = next(iter(pipe))
        if pad_to:  # widen the token arrays with padding, which the loss ignores
            for key, fill in (("tokens", 0), ("raw_tokens", 0), ("y_next", -1)):
                extra = pad_to - host[key].shape[1]
                host[key] = np.pad(host[key], ((0, 0), (0, extra)), constant_values=fill)
        batch = train.batch_to_device(host, torch.device("cuda"))
        pick = torch.rand(batch_size, generator=torch.Generator().manual_seed(0)) > 0.5
        plain_loss, plain_grads, plain_counts = _step_gradients(config, batch, pick, plain=True)
        check(sum(plain_counts.values()) == 0, f"{label}: the plain step launched a kernel")
        loss, grads, counts = _step_gradients(config, batch, pick, plain=False)
        check(grads.keys() == plain_grads.keys(), f"{label}: the two steps reach other parameters")
        worst, worst_name = 0.0, ""
        for name, g in grads.items():
            ref = plain_grads[name]
            # the order of sums only, through 4 + 2 layers and two passes
            tol = 1e-4 * max(1.0, float(ref.abs().max()))
            err = float((g - ref).abs().max())
            check(err <= tol, f"{label}: gradient of {name} differs by {err} (tolerance {tol})")
            if err / tol > worst:
                worst, worst_name = err / tol, name
        rel = abs(loss - plain_loss) / abs(plain_loss)
        check(rel <= 1e-5, f"{label}: loss {loss} against {plain_loss} through the plain versions")
        emit({"phase": "train_fp32_vs_plain", "route": label, "batch": batch_size,
              "T": int(batch["tokens"].shape[1]), "atoms": int(batch["atoms"].shape[1]),
              "layers_xformer_egnn": [4, 2], "loss": loss, "plain_loss": plain_loss,
              "loss_rel_diff": rel, "parameters_compared": len(grads),
              "worst_gradient_err_over_tol": worst, "worst_parameter": worst_name,
              "launches": counts})
        return counts

    counts = one("packed", 64, 80, None)
    check(counts["packed_causal_attention_backward"] == 8 and counts["egnn_messages_backward"] == 2
          and counts["flash_causal_attention"] == 0,
          f"packed route: launches {counts}")
    counts = one("flash_T200", 32, 200, 200)
    check(counts["flash_causal_attention"] == 16 and counts["packed_causal_attention"] == 0
          and counts["packed_causal_attention_backward"] == 0,
          f"flash route: launches {counts}")


# COATI2 grande: the recipe of examples/train_coati2.py (16 x 512, 16 heads
# of 32, n_seq 128, SwiGLU-resnet heads, the coati2_12_12 vocabulary)
COATI2_GRANDE = dict(n_layer_xformer=16, n_hidden_xformer=512, embed_dim=512, n_head=16,
                     n_seq=128, enc_to_coati="swiglu_resnet", n_direct_clr=64)
COATI2_DOC = ROOT / "coati_tpu_torch" / "_build" / "coati2_grande_seed0.pkl"


def _coati2_tokenizer():
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    return TrieTokenizer(n_seq=COATI2_GRANDE["n_seq"], **get_vocab("coati2_12_12"))


def _coati2_corpus(tok, n):
    """The first n corpus SMILES whose [SMILES]...[STOP] fits n_seq."""
    out = []
    with gzip.open(CORPUS, "rt") as f:
        for line in f:
            s = line.strip()
            with contextlib.suppress(KeyError):
                if len(tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False,
                                         range_check=False)) <= tok.n_seq:
                    out.append(s)
            if len(out) == n:
                return out
    return out


def _top2_margin(model, tok, h, row, pos):
    """The plain version's margin between its two largest logits at the
    step that chose token `pos` of `row`, teacher-forced in float32."""
    from coati_tpu_torch.models.transformer import forward_logits

    with plain_versions(), torch.no_grad():
        tokens = torch.as_tensor(np.asarray(row)[None], device="cuda")
        inject = model._clip_token(np.asarray(h, np.float32)[None])
        logits = forward_logits(model._compute.xformer, model.config.xformer_config, tokens,
                                inject, tok.unk_token)[0, pos - 1].float()
    top = logits.topk(2).values
    return float(top[0] - top[1])


def phase_coati2():
    """COATI2 grande on the card (inference): seeded fresh weights written
    as a reference-format document and read back by load_coati2; an fp32
    greedy round trip through the kernels and through the plain versions;
    the production round trip of 1,024 corpus SMILES; one
    property-conditioned decode. Returns the launch counts of the path."""
    from coati_tpu_torch.data.xform_coati2 import property_tokens
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2, model_to_state, serialize_model
    from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, fresh_model

    tok = _coati2_tokenizer()
    config = Coati2TrainConfig(**COATI2_GRANDE)
    model = fresh_model(config.model_config(tok.n_token), torch.device("cpu"), seed=0)
    COATI2_DOC.parent.mkdir(parents=True, exist_ok=True)
    COATI2_DOC.write_bytes(serialize_model(
        train_args={"tokenizer_vocab": "coati2_12_12"}, dataset_summary={},
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(tok.n_token)))
    del model
    start = time.perf_counter()
    m, tok = load_coati2(str(COATI2_DOC))  # no device: the card
    check(m.device.type == "cuda", f"coati2: model loaded on {m.device}, not the card")
    cfg, n_layer = m.config, m.config.n_layer_xformer
    emit({"phase": "coati2_load", "seconds": time.perf_counter() - start,
          "config": {k: getattr(cfg, k) for k in (*COATI2_GRANDE, "n_tok")},
          "head_dim": cfg.xformer_config.head_dim,
          "parameters": sum(p.numel() for p in m.params.parameters())})
    check(cfg.xformer_config.head_dim == 32, "coati2: head dim is not 32")
    smiles = _coati2_corpus(tok, 1024)
    check(len(smiles) == 1024, f"coati2: {len(smiles)} corpus SMILES fit n_seq")
    tokens = _tokens(tok, smiles, tok.n_seq)

    # fidelity: fp32 greedy, 64 rows, through the plain versions and the kernels
    fid = tokens[:64]

    def greedy():
        h = m.encode_tokens(fid, tok)
        out, rows = m.hcoati_to_2d_batch(h, tok, k=1, keep_special=True, return_tokens=True)
        return h.float().cpu().numpy(), rows

    with plain_versions():
        (plain_h, plain_rows), _, plain_launches = _timed(greedy)
    check(sum(plain_launches.values()) == 0, "coati2: the plain run launched a kernel")
    _zero_counts()  # the path starts here
    (h, rows), seconds, launches = _timed(greedy)
    agree = sum(a == b for a, b in zip(rows, plain_rows))
    differing = []
    for i, (a, b) in enumerate(zip(rows, plain_rows)):
        if a != b:
            pos = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            differing.append({"row": i, "position": pos,
                              "plain_top2_margin": _top2_margin(m, tok, plain_h[i], b, pos)})
    h_diff = float(np.abs(h - plain_h).max())
    emit({"phase": "coati2_fp32_greedy", "rows": 64, "agree_with_plain": agree,
          "embedding_max_abs_diff": h_diff, "differing_rows": differing,
          "seconds": seconds, "launches": launches})
    check(h_diff <= 1e-5, f"coati2 fp32: embeddings differ by {h_diff}")
    check(agree >= 63, f"coati2 fp32: only {agree}/64 rows agree with the plain versions")
    check(all(d["plain_top2_margin"] < 1e-4 for d in differing),
          f"coati2 fp32: a row first differs where the plain margin is not under 1e-4: "
          f"{differing}")
    check(launches["flash_causal_attention"] == 2 * n_layer
          and launches["decode_attention"] % n_layer == 0 and launches["decode_attention"] > 0,
          f"coati2 fp32: launches {launches}")

    # production: bf16 with the int8 KV cache, batch 1024
    prod = COATI2(m.params, cfg.replace(dtype="bfloat16"), seed=0)
    check(prod.config.xformer_config.kv_quantized, "coati2: bf16 does not quantize the cache")
    kw = dict(k=100, inv_temp=2.0)
    runs = [_round_trip(prod, tok, tokens, **kw) for _ in range(4)]  # the first is warm-up
    for out, emb, _, run_launches in runs:
        check(len(out) == 1024 and np.isfinite(emb).all()
              and emb.shape == (1024, cfg.embed_dim),
              "coati2: rows not decoded or embeddings not finite")
        check(run_launches["flash_causal_attention"] == 2 * n_layer
              and run_launches["packed_causal_attention"] == 0,
              f"coati2: full-sequence kernel counts {run_launches}")
        steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
        check(steps > 0 and rem == 0, f"coati2: int8 decode kernel count {run_launches}")
    seconds = statistics.median(r[2] for r in runs[1:])
    encode_s = statistics.median(
        _timed(lambda: prod.encode_tokens(tokens, tok))[1] for _ in range(3))
    last = runs[-1][3]
    emit({"phase": "coati2_production", "batch": 1024, "dtype": "bfloat16", "kv": "int8/float32",
          "k": 100, "inv_temp": 2.0, "encode_T": tok.n_seq, "seconds": seconds,
          "seconds_all": [r[2] for r in runs], "mol_per_s": 1024 / seconds,
          "encode_seconds": encode_s, "decode_steps": last["decode_attention_quant"] // n_layer,
          "max_decode_steps": tok.n_seq - 3,
          "k2_launches": last["flash_causal_attention"],
          "k1_launches": last["decode_attention_quant"], "launches_per_call": last,
          "exact_round_trips": sum(a == b for a, b in zip(runs[-1][0], smiles)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    _profile(lambda: prod.smiles_to_2d_batch(tokens, tok, **kw), "coati2_production", seconds)

    # a property-conditioned prefix, through hcoati_to_2d_batch
    block = property_tokens(smiles[0], tok)
    check(block.startswith("[PROPS]"), f"coati2: no conditioning block for {smiles[0]}")
    fill = block + "[SMILES]"
    h_prod = prod.encode_tokens(tokens, tok)
    (out, rows), seconds, launches = _timed(lambda: prod.hcoati_to_2d_batch(
        h_prod, tok, fill_in_from=fill, keep_special=True, return_tokens=True, **kw))
    prefix = tok.tokenize_text("[CLIP][UNK]" + fill, pad=False)
    check(all(r[: len(prefix)] == prefix for r in rows), "coati2: a row lost its prefix")
    emit({"phase": "coati2_conditioned", "batch": 1024, "fill_in_from": fill,
          "prefix_tokens": len(prefix), "seconds": seconds,
          "decode_steps": launches["decode_attention_quant"] // n_layer, "launches": launches})
    counts = _counts()  # the path ends here
    # K2 in bf16 at the encode and at both prefills
    plain_prefix = len(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    hold_path_shapes("coati2", [
        ("flash_causal_attention", 1024, t, cfg.n_head, cfg.xformer_config.head_dim, "bfloat16")
        for t in (tok.n_seq, plain_prefix, len(prefix))])
    return counts


def phase_coati2_train():
    """The COATI2 training path: train_coati2 with the grande recipe in
    bf16 on corpus rows with only a 'smiles' column. Returns the launch
    counts of the path."""
    from coati_tpu_torch.data.batch_pipe import SmilesRows
    from coati_tpu_torch.models.coati2 import COATI2
    from coati_tpu_torch.models.io import load_coati2, model_to_state, serialize_model
    from coati_tpu_torch.training import train_coati2 as tt2

    warm, timed = 3, 10
    steps = warm + timed
    config = tt2.Coati2TrainConfig(**COATI2_GRANDE, batch_size=160, lr=5e-4, n_epochs=1,
                                   dtype="bfloat16")
    tok = _coati2_tokenizer()
    with gzip.open(CORPUS, "rt") as f:
        corpus = f.read().split()
    # rows with only a 'smiles' column, so that the transform computes the
    # properties as in a user's run, in a seeded order; one batch more than
    # is trained on: the loop takes it before it stops
    picked = corpus[: (steps + 1) * config.batch_size]
    order = np.random.default_rng(0).permutation(len(picked))
    data = _StampedDataset(SmilesRows(picked[i] for i in order))
    torch.cuda.reset_peak_memory_stats()
    random.seed(0)  # the transform draws from the global random module
    _zero_counts()  # the path starts here
    start = time.perf_counter()
    model, results = tt2.train_coati2(config, data, max_steps_per_epoch=steps, seed=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - start
    counts = _counts()  # and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    history = results["history"]
    check(len(history) == steps, f"coati2_train: {len(history)} steps, not {steps}")
    losses = np.array([h[3:] for h in history], np.float64)  # loss, ar_loss, clr_loss
    check(bool(np.isfinite(losses).all()), "coati2_train: a loss is not finite")
    check(losses[-1, 1] < losses[0, 1],
          f"coati2_train: ar_loss went from {losses[0, 1]} to {losses[-1, 1]}")
    per_step = {name: c / steps for name, c in counts.items()}
    n_x = config.n_layer_xformer
    # the doubled views and the AR pass, each recomputed once under remat
    expected = {"packed_causal_attention": 4 * n_x, "packed_causal_attention_backward": 2 * n_x,
                "flash_causal_attention": 0, "decode_attention": 0, "decode_attention_quant": 0,
                "egnn_messages": 0, "egnn_messages_backward": 0}
    check(per_step == expected, f"coati2_train: launches a step {per_step}, expected {expected}")
    intervals = np.diff(data.stamps)[warm:]
    check(len(intervals) == timed, f"coati2_train: {len(intervals)} timed steps, not {timed}")
    step_s = float(np.median(intervals))
    widths = sorted({(b["tokens"].shape[1], b["raw_tokens"].shape[1])
                     for b in data.batches[:steps]})
    # K5f and K5b in bf16 at the widths the run took: the AR pass (B 160)
    # at the targets' width, the two views as one batch (B 320) at theirs
    head = (config.n_head, config.n_hidden_xformer // config.n_head, "bfloat16")
    hold_path_shapes("coati2_train", [
        (kernel, b, t, *head) for t_ar, t_views in widths
        for b, t in ((config.batch_size, t_ar), (2 * config.batch_size, t_views))
        for kernel in ("packed_causal_attention", "packed_causal_attention_backward")])
    emit({"phase": "coati2_train", "recipe": "examples/train_coati2.py grande",
          "dtype": config.dtype, "batch": config.batch_size, "n_seq": config.n_seq,
          "xformer": [n_x, config.n_hidden_xformer, config.n_head], "remat": config.remat,
          "parameters": sum(p.numel() for p in model.parameters()),
          "warmup_steps": warm, "timed_steps": timed,
          "step_seconds": step_s, "step_seconds_all": [float(x) for x in np.diff(data.stamps)],
          "mol_per_s": config.batch_size / step_s,
          "trainer_step_seconds_all": results["train_step_seconds"],
          "train_coati2_seconds": total_s, "batch_widths_tokens_views": widths,
          "loss_first_last": [losses[0, 0], losses[-1, 0]],
          "ar_loss_first_last": [losses[0, 1], losses[-1, 1]],
          "clr_loss_first_last": [losses[0, 2], losses[-1, 2]],
          "ar_loss_all": [float(x) for x in losses[:, 1]],
          "launches_per_step": per_step, "peak_mem_gb": peak_gb})

    props_id = tok.tokenize_text("[PROPS]", pad=False)[0]
    with_props = sum(int((b["tokens"][:, 0] == props_id).sum()) for b in data.batches[:steps])
    in_run = float(np.median(data.xform_s[:steps]))
    emit({"phase": "coati2_host_pipeline", "batch": config.batch_size, "batches": steps,
          "p_props": config.p_props, "xform_in_run_s": in_run,
          "xform_in_run_s_all": data.xform_s[:steps], "step_seconds": step_s,
          "in_run_share_of_step": in_run / step_s,
          "rows_with_properties": with_props, "rows": steps * config.batch_size})
    check(0 < with_props < steps * config.batch_size,
          f"coati2_train: {with_props} rows drew properties")

    # the run's document, read back by load_coati2, encodes as the model does
    path = COATI2_DOC.with_name("coati2_trained.pkl")
    path.write_bytes(serialize_model(
        train_args=config.as_dict(), dataset_summary=data.summary,
        model_state=model_to_state(model), model_kwargs=config.model_kwargs(tok.n_token)))
    loaded, ltok = load_coati2(str(path))
    rows = _tokens(ltok, corpus[:8], ltok.n_seq)
    h = loaded.encode_tokens(rows, ltok)
    direct = COATI2(model.eval(), loaded.config).encode_tokens(rows, tok)
    diff = float((h - direct).abs().max())
    emit({"phase": "coati2_train_document", "rows": 8, "shape": list(h.shape),
          "finite": bool(torch.isfinite(h).all()), "max_abs_diff_vs_trained_model": diff})
    check(h.shape == (8, config.embed_dim) and bool(torch.isfinite(h).all()) and diff <= 1e-5,
          f"coati2_train: the reloaded document encodes {diff} away")

    # three traced steps on batches made before, outside the counted window
    step = tt2.Coati2TrainStep(
        model.train(), config.model_config(tok.n_token),
        tt2.make_optimizer(config, model), stop_token=tok.stop_token,
        unk_token=tok.unk_token, pad_token=tok.pad_token,
        token_entropy_unit=float(np.log2(tok.n_token)))
    batches = [tt2.batch_to_device(b, torch.device("cuda")) for b in data.batches[-4:]]
    step(batches[0])  # warm-up: makes the optimizer's state
    _, wall_s, _ = _timed(lambda: [step(b) for b in batches[1:]])
    _profile(lambda: [step(b) for b in batches[1:]], "coati2_train_step_x3", wall_s, top=24)

    return counts


def phase_coati2_fp32_vs_plain():
    """One float32 COATI2 step at full width (4 layers of 512, 16 heads of
    32), batch 32, T <= 128, through the kernels (K5f, K5b) and through their
    plain versions: the loss and every parameter's gradient must agree."""
    from coati_tpu_torch.data.xform_coati2 import coati2_ar_xform
    from coati_tpu_torch.training import train_coati2 as tt2

    config = tt2.Coati2TrainConfig(**dict(COATI2_GRANDE, n_layer_xformer=4), batch_size=32)
    tok = _coati2_tokenizer()
    model_cfg = config.model_config(tok.n_token)
    with gzip.open(CORPUS, "rt") as f:
        rows = [next(f).strip() for _ in range(32)]
    random.seed(0)
    host = coati2_ar_xform({"smiles": rows}, tok, rng=random.Random(0))
    batch = tt2.batch_to_device(host, torch.device("cuda"))

    def one(plain):
        model = tt2.fresh_model(model_cfg, torch.device("cuda"), seed=0)
        step = tt2.Coati2TrainStep(model, model_cfg, None, stop_token=tok.stop_token,
                                   unk_token=tok.unk_token, pad_token=tok.pad_token,
                                   token_entropy_unit=float(np.log2(tok.n_token)))
        _zero_counts()
        with plain_versions() if plain else contextlib.nullcontext():
            loss, _, _ = step.losses(batch)
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}, _counts()

    plain_loss, plain_grads, plain_counts = one(True)
    check(sum(plain_counts.values()) == 0, "coati2_fp32_vs_plain: the plain step launched")
    loss, grads, counts = one(False)
    check(counts["packed_causal_attention_backward"] == 2 * 4
          and counts["flash_causal_attention"] == 0, f"coati2_fp32_vs_plain: launches {counts}")
    worst, worst_name = 0.0, ""
    for name, g in grads.items():
        ref = plain_grads[name]
        check(g is not None and ref is not None, f"coati2_fp32_vs_plain: no gradient for {name}")
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        err = float((g - ref).abs().max())
        check(err <= tol, f"coati2_fp32_vs_plain: gradient of {name} differs by {err} (tol {tol})")
        if err / tol > worst:
            worst, worst_name = err / tol, name
    rel = abs(loss - plain_loss) / abs(plain_loss)
    emit({"phase": "coati2_fp32_vs_plain", "batch": 32, "T": int(batch["tokens"].shape[1]),
          "views_T": int(batch["raw_tokens"].shape[1]), "layers": 4, "loss": loss,
          "plain_loss": plain_loss, "loss_rel_diff": rel, "parameters_compared": len(grads),
          "worst_gradient_err_over_tol": worst, "worst_parameter": worst_name,
          "launches": counts})
    check(rel <= 1e-5, f"coati2_fp32_vs_plain: loss {loss} against {plain_loss}")


def _profile(fn, label, wall_s, top=12):
    """Device time by kernel over one call of fn (torch.profiler): the top
    kernels and every kernel of the port's own; and the card's idle share
    against the call's unprofiled time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from coati_tpu_torch.ops.kernels import build

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: an aten op's device time repeats that of its kernels, and
    # a user annotation on the device timeline (the optimizer's step) spans
    # the gaps between them
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    busy_s = sum(t for _, t, _ in rows) / 1e6
    rows = sorted(rows, key=lambda r: -r[1])
    # the port's own kernels by name, whatever their rank (names from ptxas)
    ours = {k.split("<")[0] for log in build.BUILD_LOG.values() for k in ptxas_usage(log)}
    port = [r for r in rows if ours and re.search(r"\b(" + "|".join(ours) + r")\b", r[0])]
    emit({"phase": "profile", "shape": label, "device_busy_s": busy_s,
          "call_s": wall_s, "idle_share": 1 - busy_s / wall_s,
          "kernel_launches": sum(c for _, _, c in rows),
          "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in rows[:top]],
          "port_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in port]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import coati_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    started = time.perf_counter()
    emit(host_cpu())

    def lap(phase):
        emit({"phase": "elapsed", "after": phase, "seconds": time.perf_counter() - started})

    phase_build()
    lap("build")
    chosen = phase_kernels()
    lap("kernels")
    phase_routing()
    lap("routing")
    phase_chem()
    lap("chem")
    model, tok = load_model()
    paths = {}
    paths["smiles"], flash_run = phase_smiles(model, tok)
    lap("smiles")
    paths["points"] = phase_points(model, tok)
    lap("points")
    paths["points_from_smiles"] = phase_points_from_smiles(model, tok)
    lap("points_from_smiles")
    paths["packed"] = phase_packed(model, tok, flash_run)
    lap("packed")
    phase_k1_positions(model.config.n_layer_xformer)
    lap("k1_positions")
    del model
    paths["coati2"] = phase_coati2()
    lap("coati2")
    paths["train"] = phase_train()
    lap("train")
    phase_train_fp32_vs_plain()
    lap("train_fp32_vs_plain")
    paths["coati2_train"] = phase_coati2_train()
    lap("coati2_train")
    phase_coati2_fp32_vs_plain()
    lap("coati2_fp32_vs_plain")
    emit({"phase": "launches", "by_path": paths})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: unavailable")
    csrc, pallas = "coati_tpu_torch/csrc/", "coati_tpu/ops/pallas/"
    sources = {
        "flash_causal_attention": ("flash_attention.cu", "flash_attention.py:121"),
        "decode_attention": ("decode_attention.cu", "decode_attention.py:205"),
        "decode_attention_quant": ("decode_attention.cu", "decode_attention.py:205"),
        "egnn_messages": ("egnn_messages.cu", "egnn_messages.py:205"),
        "packed_causal_attention": ("packed_attention.cu", "packed_attention.py:142"),
        "egnn_messages_backward": ("egnn_messages_bwd.cu", "egnn_messages.py:329"),
        "packed_causal_attention_backward": ("packed_attention_bwd.cu",
                                             "packed_attention.py:282"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        c = chosen[name]
        launches = sum(counts[name] for counts in paths.values())
        check(launches > 0, f"{name} was not launched on any main path")
        kernels.append({
            "name": name, "route": "cuda", "source": csrc + source, "replaces": pallas + replaces,
            "launches": launches, "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "ok": True,  # every case of every kernel passed, or phase 2 exited
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
