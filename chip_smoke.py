#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coati_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, in order; any failure ends the run with a non-zero exit:

 1. build: nvcc builds every kernel under coati_tpu_torch/csrc for sm_90a,
    one process per source, all at once.
 2. kernels: each kernel against its plain PyTorch version on the card, on
    the main path's shapes, within a stated tolerance; each timed with CUDA
    events (median of 25 launches after warm-up, L2 flushed before each),
    beside its bound and, where one PyTorch call computes the same
    function, that call (a yardstick only: the port never calls it).
 3. slice: the trained grande document docs/eval_model_r5.pkl on the card,
    through the user entry points: (a) an fp32 greedy round trip of 64
    SMILES through the kernels and through the plain versions; (b) the
    production setting, bf16 with an int8 KV cache, at batch 1024, k 100,
    inverse temperature 2, at the document's n_seq 250 and at total_len 96,
    each with its encode timed alone and one round trip traced by
    torch.profiler (device time by kernel, the card's idle share).
    Kernel launch counts are zeroed just before (a) and read just after (b).
 4. report: the card's name and power limit, one `kernels` JSON line, and
    as the last line {"ok": true, "device": {...}}.

Every number printed is measured in this run, on this card, except the
bounds, which are computed from this run's shapes and the card's published
peaks (H100 SXM: 3.35 TB/s; 989 TFLOP/s bf16; 67 TFLOP/s fp32).
"""

from __future__ import annotations

import contextlib
import gzip
import json
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
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", flush=True)
        sys.exit(1)


# ------------------------------------------------------------- timing


_FLUSH = None


def time_ms(fn, n: int = 25, warmup: int = 3) -> float:
    """Median device time of fn() in ms, by CUDA events around each call,
    with a 256 MB write before each to evict the 50 MB L2."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(n):
        _FLUSH.zero_()
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


def tolerance(ref: torch.Tensor, dtype: torch.dtype, fp32_tol: float) -> float:
    """bf16 output: 2 bf16 ulps of the output scale (rounding of the output
    and of the plain version's bf16 scores and probs); float32: fp32_tol
    (summation order only)."""
    if dtype == torch.bfloat16:
        return 2 * BF16_ULP * float(ref.float().abs().max())
    return fp32_tol


# -------------------------------------------------------------- phases


def phase_build():
    from coati_tpu_torch.ops.kernels import build

    seconds = build.build()
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    emit({"phase": "build", "sources": list(build.SOURCES), "seconds": round(seconds, 2),
          "arch": "sm_90a"})


def _flash_case(b, t, h, dh, dtype, gen):
    from coati_tpu_torch.ops.attention import causal_attention
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention

    # strided q/k/v views of one fused projection, as the model passes them
    qkv = torch.randn(b, t, 3 * h * dh, generator=gen, device="cuda").to(dtype)
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    out = flash_causal_attention(q, k, v)
    ref = causal_attention(q, k, v, torch.float32)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    tol = tolerance(ref, dtype, 1e-5)
    elt = torch.finfo(dtype).bits // 8
    bound, by = bound_ms(4 * b * t * h * dh * elt, 4 * b * h * (t * (t + 1) // 2) * dh, dtype)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return {
        "kernel": "flash_causal_attention", "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "ms": time_ms(lambda: flash_causal_attention(q, k, v)),
        "plain_ms": time_ms(lambda: causal_attention(q, k, v, torch.float32)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        ),
    }


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
    out, ref = run(), run_plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # int8 with a float32 query compares in float32, before any final cast
    tol = tolerance(ref, q_dtype, 1e-4 if isinstance(kv, str) else 1e-5)
    bound, by = bound_ms(n_bytes, 4 * b * h * live * dh, ops_dtype)
    return {
        "kernel": name, "shape": [b, t, h, dh], "pos": pos, "q_dtype": str(q_dtype)[6:],
        "kv": kv if isinstance(kv, str) else str(kv)[6:],
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "ms": time_ms(run), "plain_ms": time_ms(run_plain), "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(library) if library else None,
    }


def phase_kernels():
    """Every kernel against its plain version; returns the case of each
    kernel at the production shape, for the report."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        _flash_case(1024, 96, 16, 16, bf16, gen),
        _flash_case(1024, 96, 16, 16, f32, gen),
        _flash_case(1024, 250, 16, 16, bf16, gen),
        _flash_case(1024, 250, 16, 16, f32, gen),
        _flash_case(1024, 3, 16, 16, bf16, gen),  # prefill of [CLIP][UNK][SMILES]
        _flash_case(3, 37, 4, 32, f32, gen),
        _flash_case(3, 37, 4, 32, bf16, gen),
        _flash_case(2, 70, 2, 64, f32, gen),
    ]
    for pos in (0, 95, 249):
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, bf16, gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/float32", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, f32, "int8/bfloat16", gen))
        cases.append(_decode_case(1024, 250, 16, 16, pos, bf16, "int8/float32", gen))
    cases.append(_decode_case(64, 250, 16, 16, 95, f32, f32, gen))  # the fp32 round trip's
    cases.append(_decode_case(3, 40, 4, 32, 17, f32, f32, gen))
    for case in cases:
        emit({"phase": "kernel", **case})
    bad = [c for c in cases if not c["ok"]]
    check(not bad, f"{len(bad)} kernel case(s) outside tolerance")
    pick = {
        "flash_causal_attention": ([1024, 250, 16, 16], "bfloat16", None),
        "decode_attention": ([1024, 250, 16, 16], "bfloat16", 95),
        "decode_attention_quant": ([1024, 250, 16, 16], "bfloat16", 95),
    }
    chosen = {}
    for c in cases:
        shape, dtype, pos = pick[c["kernel"]]
        if c["shape"] == shape and c.get("q_dtype", c.get("dtype")) == dtype and c.get("pos") == pos:
            chosen.setdefault(c["kernel"], c)
    return chosen


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention to the plain versions, for comparison:
    swaps the kernel wrappers the transformer module calls."""
    from coati_tpu_torch.models import transformer
    from coati_tpu_torch.ops import attention as plain

    saved = {n: getattr(transformer, n) for n in
             ("flash_causal_attention", "decode_attention", "decode_attention_quant")}
    transformer.flash_causal_attention = lambda q, k, v: plain.causal_attention(q, k, v, torch.float32)
    transformer.decode_attention = plain.decode_attention
    transformer.decode_attention_quant = plain.decode_attention_quant
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(transformer, n, fn)


def _wrappers():
    from coati_tpu_torch.ops.kernels.decode_attention import decode_attention, decode_attention_quant
    from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention

    return {w.__name__: w for w in (flash_causal_attention, decode_attention, decode_attention_quant)}


def _counts():
    return {name: w.launches for name, w in _wrappers().items()}


def _tokens(tok, smiles, width):
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _round_trip(model, tok, tokens, **kw):
    """One timed round trip; returns (smiles, hclip, seconds, launches)."""
    before = _counts()
    torch.cuda.synchronize()
    start = time.perf_counter()
    smiles, h = model.smiles_to_2d_batch(tokens, tok, return_embeddings=True, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {n: c - before[n] for n, c in _counts().items()}
    return smiles, h, seconds, launches


def phase_slice():
    """The main path: the trained document round-tripping on the card.
    Returns the launch counts of the run."""
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    start = time.perf_counter()
    model, tok = load_e3gnn_smiles_clip_e2e(str(DOC))  # no device: the card
    check(model.device.type == "cuda", f"model loaded on {model.device}, not the card")
    n_layer = model.config.n_layer_xformer
    emit({"phase": "load", "doc": DOC.name, "seconds": time.perf_counter() - start,
          "n_layer": n_layer, "n_embd": model.config.n_hidden_xformer,
          "n_head": model.config.n_head, "n_seq": model.config.n_seq, "n_tok": tok.n_token})

    # (a) fp32 greedy: kernels against plain versions, 64 corpus SMILES
    corpus = gzip.open(CORPUS, "rt").read().split()
    picks = [corpus[i] for i in np.random.default_rng(0).permutation(len(corpus))[:64]]
    tokens = _tokens(tok, picks, tok.n_seq)
    with plain_attention():
        plain_smiles, plain_h, _, plain_launches = _round_trip(model, tok, tokens, k=1)
    check(sum(plain_launches.values()) == 0, "the plain run launched a kernel")

    for w in _wrappers().values():  # the main path starts here
        w.launches = 0
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
    bench = (BENCH_SMILES * 64)[:1024]
    for label, total_len in (("n_seq_250", None), ("total_len_96", 96)):
        width = total_len or tok.n_seq
        tokens = _tokens(tok, bench, width)
        runs = [_round_trip(prod, tok, tokens, k=100, inv_temp=2.0, total_len=total_len)
                for _ in range(4)]  # the first is warm-up
        for out, _, _, run_launches in runs:
            check(len(out) == 1024 and all(isinstance(s, str) for s in out), "rows not decoded")
            check(run_launches["flash_causal_attention"] == 2 * n_layer,
                  f"{label}: flash kernel count {run_launches}")
            steps, rem = divmod(run_launches["decode_attention_quant"], n_layer)
            check(steps > 0 and rem == 0, f"{label}: int8 decode kernel count {run_launches}")
        seconds = statistics.median(r[2] for r in runs[1:])
        out = runs[-1][0]
        encode_s = statistics.median(_encode_seconds(prod, tok, tokens) for _ in range(3))
        emit({"phase": "production", "shape": label, "batch": 1024, "dtype": "bfloat16",
              "kv": "int8/float32", "k": 100, "inv_temp": 2.0, "encode_T": width,
              "mol_per_s": 1024 / seconds, "seconds": seconds,
              "seconds_all": [r[2] for r in runs], "encode_seconds": encode_s,
              "decode_steps": runs[-1][3]["decode_attention_quant"] // n_layer,
              "launches_per_round_trip": runs[-1][3],
              "exact_round_trips": sum(a == b for a, b in zip(out, bench)),
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        _profile(prod, tok, tokens, label, seconds, k=100, inv_temp=2.0, total_len=total_len)
    return _counts()


def _encode_seconds(model, tok, tokens) -> float:
    torch.cuda.synchronize()
    start = time.perf_counter()
    model.encode_tokens(tokens, tok)
    torch.cuda.synchronize()
    return time.perf_counter() - start


def _profile(model, tok, tokens, label, wall_s, **kw):
    """Device time by kernel over one round trip (torch.profiler), and the
    card's idle share against the unprofiled round-trip time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.smiles_to_2d_batch(tokens, tok, **kw)
        torch.cuda.synchronize()
    # kernels only: an aten op's device time repeats that of its kernels
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(t for _, t, _ in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:12]
    emit({"phase": "profile", "shape": label, "device_busy_s": busy_s,
          "round_trip_s": wall_s, "idle_share": 1 - busy_s / wall_s,
          "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import coati_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    phase_build()
    chosen = phase_kernels()
    launches = phase_slice()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: unavailable")
    sources = {
        "flash_causal_attention": ("coati_tpu_torch/csrc/flash_attention.cu",
                                   "coati_tpu/ops/pallas/flash_attention.py:121"),
        "decode_attention": ("coati_tpu_torch/csrc/decode_attention.cu",
                             "coati_tpu/ops/pallas/decode_attention.py:205"),
        "decode_attention_quant": ("coati_tpu_torch/csrc/decode_attention.cu",
                                   "coati_tpu/ops/pallas/decode_attention.py:205"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        c = chosen[name]
        check(launches[name] > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": c["max_abs_err"], "ms": c["ms"],
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
