#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (coati_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

With CHIP_SMOKE_LOG=<file> in the environment, every JSON line it prints is
also appended to that file.

Phases, in order; any failure ends the run with a non-zero exit:

 1. build: nvcc builds every kernel under coati_tpu_torch/csrc for sm_90a,
    one process per source, all at once.
 2. kernels: each kernel against its plain PyTorch version on the card, on
    the main paths' shapes, within a stated tolerance; each timed with CUDA
    events (median of 25 launches after warm-up, L2 flushed before each),
    beside its bound and, where one PyTorch call computes the same
    function, that call (a yardstick only: the port never calls it).
 3. paths: the trained grande document docs/eval_model_r5.pkl on the card,
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
    packed: the total_len 96 production round trip again under
    prefill_kernel="packed", which sends every full-sequence attention to
    the short-sequence kernel.
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
import os
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


def _attention_case(name, b, t, h, dh, dtype, gen):
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
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    case = {
        "kernel": name, "shape": [b, t, h, dh], "dtype": str(dtype)[6:],
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "ms": time_ms(lambda: kernel(q, k, v)),
        "plain_ms": time_ms(lambda: causal_attention(q, k, v, torch.float32)),
        "bound_ms": bound, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        ),
    }
    if kernel is packed_causal_attention:
        case["k2_ms"] = time_ms(lambda: flash_causal_attention(q, k, v))
    return case


def _fixture_geometry(rows=None):
    """(d2, w, atom counts) of the fixture's molecules on the card, as
    egnn_forward computes them at the document's cutoff of 5 Angstrom."""
    from coati_tpu_torch.data import load_points_fixture
    from coati_tpu_torch.models.egnn import pair_geometry

    _, atoms, coords = load_points_fixture()
    atoms, coords = atoms[:rows], coords[:rows]
    mask = torch.as_tensor(atoms > 0, device="cuda").float()
    d2, w = pair_geometry(mask, torch.as_tensor(coords, device="cuda"), 5.0)
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
    the encoder gives them."""
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
    ref = plain.egnn_messages(*args, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
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
    case = {
        "kernel": "egnn_messages", "case": label, "shape": [b, n, hm],
        "mm_dtype": str(mm_dtype)[6:], "live_pairs": pairs, "dense_pairs": b * n * n,
        "padding_rows_zero": bool((out[w.abs().sum(-1) == 0] == 0).all()),
        "max_abs_err": err, "tol": tol, "ok": err <= tol,
        "bound_ms": bound, "bound_by": by, "library_ms": None,
    }
    case["ok"] = case["ok"] and case["padding_rows_zero"]
    if timed:
        case["ms"] = time_ms(lambda: egnn_messages(*args, mm_dtype=mm_dtype))
        case["plain_ms"] = time_ms(
            lambda: plain.egnn_messages(*args, mm_dtype=mm_dtype), n=3, warmup=1
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
    k2, k5f = "flash_causal_attention", "packed_causal_attention"
    cases = [
        _attention_case(k2, 1024, 96, 16, 16, bf16, gen),
        _attention_case(k2, 1024, 96, 16, 16, f32, gen),
        _attention_case(k2, 1024, 250, 16, 16, bf16, gen),
        _attention_case(k2, 1024, 250, 16, 16, f32, gen),
        _attention_case(k2, 1024, 3, 16, 16, bf16, gen),  # prefill of [CLIP][UNK][SMILES]
        _attention_case(k2, 3, 37, 4, 32, f32, gen),
        _attention_case(k2, 3, 37, 4, 32, bf16, gen),
        _attention_case(k2, 2, 70, 2, 64, f32, gen),
        _attention_case(k5f, 1024, 96, 16, 16, bf16, gen),
        _attention_case(k5f, 1024, 96, 16, 16, f32, gen),
        _attention_case(k5f, 1024, 3, 16, 16, bf16, gen),
        _attention_case(k5f, 1024, 128, 16, 16, bf16, gen),
        _attention_case(k5f, 1024, 128, 16, 16, f32, gen),
        _attention_case(k5f, 3, 37, 4, 32, f32, gen),
        _attention_case(k5f, 2, 70, 2, 64, bf16, gen),
    ]
    # K3: ragged molecules with a lone atom and an all-padding row, small odd
    # shapes, then the fixture's 1,024 molecules (timed; the main path's shape)
    ragged = [int(x) for x in torch.randint(2, 65, (64,), generator=gen, device="cuda")]
    ragged[:3] = [64, 1, 0]
    for mm in (f32, bf16):
        cases.append(_messages_case(*_random_geometry(ragged, 64, gen), 256, mm, gen, "ragged"))
    cases.append(_messages_case(*_random_geometry([11, 5, 0], 11, gen), 32, f32, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([11, 7, 3], 11, gen), 128, bf16, gen, "odd"))
    cases.append(_messages_case(*_random_geometry([9, 130], 130, gen), 20, f32, gen, "odd"))
    d2, w, _ = _fixture_geometry()
    for mm in (f32, bf16):
        cases.append(_messages_case(d2, w, 256, mm, gen, "fixture"))
    del d2, w
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
    pick = {  # the case of each wrapper that the report's line carries
        "flash_causal_attention": {"shape": [1024, 250, 16, 16], "dtype": "bfloat16"},
        "decode_attention": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16", "pos": 95},
        "decode_attention_quant": {"shape": [1024, 250, 16, 16], "q_dtype": "bfloat16",
                                   "pos": 95},
        "egnn_messages": {"case": "fixture", "mm_dtype": "float32"},
        "packed_causal_attention": {"shape": [1024, 96, 16, 16], "dtype": "bfloat16"},
    }
    chosen = {}
    for c in cases:
        if all(c.get(key) == value for key, value in pick[c["kernel"]].items()):
            chosen.setdefault(c["kernel"], c)
    return chosen


@contextlib.contextmanager
def plain_versions():
    """Route the model to the kernels' plain versions, for comparison:
    swaps the kernel wrappers that the transformer and EGNN modules call."""
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


def _counts():
    return {name: w.launches for name, w in _wrappers().items()}


def _zero_counts():
    for w in _wrappers().values():
        w.launches = 0


def _tokens(tok, smiles, width):
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.zeros((len(rows), width), np.int32)
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
    _profile(lambda: prod.points_to_2d_batch(atoms, coords, tok, **kw), "points", seconds)
    _profile(lambda: prod.encode_points(atoms, coords), "encode_points",
             statistics.median(encode_s))
    return _counts()


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


def _profile(fn, label, wall_s):
    """Device time by kernel over one call of fn (torch.profiler), and the
    card's idle share against the call's unprofiled time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # kernels only: an aten op's device time repeats that of its kernels
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_s = sum(t for _, t, _ in rows) / 1e6
    top = sorted(rows, key=lambda r: -r[1])[:12]
    emit({"phase": "profile", "shape": label, "device_busy_s": busy_s,
          "call_s": wall_s, "idle_share": 1 - busy_s / wall_s,
          "top_kernels": [{"name": n[:90], "ms": t / 1e3, "calls": c} for n, t, c in top]})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import coati_tpu_torch  # noqa: F401  (fails outside a checkout of the repository)

    started = time.perf_counter()

    def lap(phase):
        emit({"phase": "elapsed", "after": phase, "seconds": time.perf_counter() - started})

    phase_build()
    lap("build")
    chosen = phase_kernels()
    lap("kernels")
    model, tok = load_model()
    paths = {}
    paths["smiles"], flash_run = phase_smiles(model, tok)
    lap("smiles")
    paths["points"] = phase_points(model, tok)
    lap("points")
    paths["packed"] = phase_packed(model, tok, flash_run)
    lap("packed")
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
