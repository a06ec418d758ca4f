#!/usr/bin/env python3
"""The decode-configuration protocol of scripts/eval_trained_decode.py on the
port (coati_tpu_torch), on the trained grande document, and the
generation-quality protocol in the production setting beside float32.

    python3 scripts/torch_eval_trained_decode.py [--doc docs/eval_model_r5.pkl]
        [--corpus corpora/chembl_synth_v1.smi.gz] [--out docs/torch_eval_trained_decode.json]
        [--device cpu]

Runs on the CUDA card unless --device names another. Imports torch and
coati_tpu_torch only.

1. Decode configurations, each built from the one document as
   COATI(params, config.replace(...)):
     fp32       float32 weights and KV cache (the reference);
     bf16       bf16 weights, a bf16 cache (kv_dtype "compute");
     bf16+int8  bf16 weights, an int8 cache with float32 scales;
     default    config.replace(dtype="bfloat16") as it stands, the setting
                bench.py and the production paths run.
   The molecules are the generation-quality protocol's (chembl_analysis:
   split_corpus, rt_subset): 2,048 train and 2,048 holdout rows of the
   corpus, which stands in for the JAX script's chembl_pic50.pkl, absent
   from the repository. Their canonical writings are embedded once in
   float32; each configuration casts those embeddings to its compute dtype
   and injects them, as the JAX script does. Measured per configuration:
     greedy round trip (k 2, inverse temperature 20, graph-level identity)
     of each split;
     sampling statistics of `sample_b` draws (k 100, inverse temperature 2)
     from the embeddings of a seeded sample of the round-trip rows: mean
     length, stop rate, the validity proxy, and the total variation of the
     unigram token histogram against fp32's;
     token agreement (scripts/eval_int8_decode.py): the share of generated
     positions of the round trips whose token equals fp32's.
   Every configuration decodes with the same seeds. The port's top-k is
   always exact, so the JAX script's approximate top-k rows have no
   counterpart. The verdict is the JAX script's rule, taken for every
   configuration but fp32 and for each split: round trip >= fp32's - 0.02,
   TV <= 0.05.
2. The generation-quality protocol (chembl_analysis.generation_quality) on
   the `default` configuration beside the same protocol in float32: the
   fraction valid and the fraction unique each within 0.03 of float32's
   (about three binomial standard deviations at 10,240 draws), and each
   number beside docs/eval_generation_quality.json.

main writes both verdicts, with the card's name and power limit, to --out
and exits non-zero unless both hold.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from coati_tpu_torch.common.util import resolve_device  # noqa: E402
from coati_tpu_torch.examples import DEVICE_HELP  # noqa: E402
from coati_tpu_torch.examples.chembl_analysis import (  # noqa: E402
    ROUND_TRIP_CHUNK,
    ROUND_TRIP_INV_TEMP,
    ROUND_TRIP_K,
    _valid_proxy,
    generation_quality,
    roundtrip_rows,
    roundtrip_share,
    rt_subset,
    split_corpus,
)
from coati_tpu_torch.models.api import COATI  # noqa: E402
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e  # noqa: E402

DOC = ROOT / "docs" / "eval_model_r5.pkl"
CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"
RECORD = ROOT / "docs" / "eval_generation_quality.json"
OUT = ROOT / "docs" / "torch_eval_trained_decode.json"

REFERENCE = "fp32"
CONFIGS = (
    ("fp32", {"dtype": "float32"}),
    ("bf16", {"dtype": "bfloat16", "kv_dtype": "compute"}),
    ("bf16+int8", {"dtype": "bfloat16", "kv_dtype": "int8"}),
    ("default", {"dtype": "bfloat16"}),
)
PREFIX = "[CLIP][UNK][SMILES]"
RT_SEED, SAMPLE_SEED, SAMPLE_IDX_SEED = 7, 11, 0  # eval_trained_decode.py's
SAMPLE_K, SAMPLE_INV_TEMP = 100, 2.0
RT_GAP, TV_MAX = 0.02, 0.05  # eval_trained_decode.py:358-367
QUALITY = dict(rt_sample=2048, batches=10, batch_size=1024, k=10_000, inv_temp=1.75)
QUALITY_BAND = 0.03


def token_histogram(tokens: np.ndarray, n_token: int) -> np.ndarray:
    """The unigram histogram of a (rows, positions) token array, summing to 1."""
    hist = np.bincount(np.asarray(tokens).reshape(-1), minlength=n_token)
    return hist / max(hist.sum(), 1)


def histogram_tv(a: np.ndarray, b: np.ndarray) -> float:
    """Total variation between two histograms."""
    return float(0.5 * np.abs(a - b).sum())


def token_agreement(tokens: np.ndarray, ref: np.ndarray) -> float:
    """The share of positions whose token equals the reference's."""
    return float(np.mean(np.asarray(tokens) == np.asarray(ref)))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _decode(model, tok, h, k, inv_temp, chunk=ROUND_TRIP_CHUNK):
    """(smiles, (rows, n_seq) tokens) of h decoded behind PREFIX."""
    smiles, tokens = [], []
    for lo in range(0, h.shape[0], chunk):
        s, t = model.hclip_to_2d_batch(h[lo : lo + chunk], tok, inv_temp=inv_temp, k=k,
                                       return_tokens=True)
        smiles.extend(s)
        tokens.extend(t)
    return smiles, np.asarray(tokens, np.int64)


def decode_config(base, tok, changes: dict, splits: dict, sample_h) -> dict:
    """One configuration's round trips, sampling statistics and tokens:
    the document's parameters under base.config.replace(**changes)."""
    cfg = base.config.replace(**changes)
    start = time.perf_counter()
    model = COATI(base.params, cfg, seed=RT_SEED)
    out, rt_tokens = {}, []
    for name, (kept, h) in splits.items():
        decoded, tokens = _decode(model, tok, h, ROUND_TRIP_K, ROUND_TRIP_INV_TEMP)
        out[f"greedy_roundtrip_{name}"] = roundtrip_share(decoded, kept)
        rt_tokens.append(tokens)
    model = COATI(base.params, cfg, seed=SAMPLE_SEED)
    drawn, tokens = _decode(model, tok, sample_h, SAMPLE_K, SAMPLE_INV_TEMP)
    _sync(base.device)
    p = len(tok.tokenize_text(PREFIX, pad=False))
    gen = tokens[:, p:]
    xcfg = cfg.xformer_config
    out.update({
        "dtype": cfg.dtype,
        "kv": "int8/" + cfg.kv_scale_dtype if xcfg.kv_quantized else str(xcfg.compute_dtype)[6:],
        "mean_len": float(np.mean([len(s) for s in drawn])),
        "stop_rate": float(np.mean([(r == tok.stop_token).any() for r in gen])),
        "validity_proxy": float(np.mean([_valid_proxy(s, tok) for s in drawn])),
        "seconds": time.perf_counter() - start,
        "_hist": token_histogram(gen, tok.n_token),
        "_rt_tokens": np.concatenate(rt_tokens)[:, p:],
    })
    return out


def evaluate(doc, corpus, rt_sample: int = 2048, sample_b: int = 1024, device=None) -> dict:
    """Part 1 on the document `doc` (a path) and the corpus file `corpus`:
    every configuration's measures and the JAX script's verdict."""
    base, tok = load_e3gnn_smiles_clip_e2e(str(doc), device=device)
    splits = {}
    for name, rows in zip(("train", "holdout"), split_corpus(str(corpus))):
        kept, tokens = roundtrip_rows(tok, rt_subset(rows, rt_sample))
        h = torch.cat([base.encode_tokens(tokens[lo : lo + ROUND_TRIP_CHUNK], tok)
                       for lo in range(0, len(tokens), ROUND_TRIP_CHUNK)])
        splits[name] = (kept, h.float())
    h_all = torch.cat([h for _, h in splits.values()])
    idx = np.random.default_rng(SAMPLE_IDX_SEED).integers(0, h_all.shape[0], size=sample_b)
    sample_h = h_all[torch.as_tensor(idx, device=h_all.device)]

    results = {}
    for name, changes in CONFIGS:
        r = decode_config(base, tok, changes, splits, sample_h)
        ref = results.get(REFERENCE, r)
        r["hist_tv_vs_fp32"] = histogram_tv(r["_hist"], ref["_hist"])
        r["token_agreement_vs_fp32"] = token_agreement(r["_rt_tokens"], ref["_rt_tokens"])
        results[name] = r
        print(f"{name:10s} rt train {r['greedy_roundtrip_train']:.4f} holdout "
              f"{r['greedy_roundtrip_holdout']:.4f}  len {r['mean_len']:.2f}  "
              f"stop {r['stop_rate']:.4f}  valid {r['validity_proxy']:.4f}  "
              f"TV {r['hist_tv_vs_fp32']:.5f}  agree {r['token_agreement_vs_fp32']:.5f}")
    ref = results[REFERENCE]
    verdict = {}
    for name, r in results.items():
        if name == REFERENCE:
            continue
        checks = {f"roundtrip_{s}": r[f"greedy_roundtrip_{s}"]
                  >= ref[f"greedy_roundtrip_{s}"] - RT_GAP for s in splits}
        checks["tv"] = r["hist_tv_vs_fp32"] <= TV_MAX
        verdict[name] = {**checks, "ok": all(checks.values())}
    for r in results.values():
        del r["_hist"], r["_rt_tokens"]
    return {"doc": Path(doc).name, "corpus": Path(corpus).name,
            "rt_rows": {s: len(kept) for s, (kept, _) in splits.items()},
            "sample_batch": sample_b, "roundtrip": {"k": ROUND_TRIP_K,
                                                    "inv_temp": ROUND_TRIP_INV_TEMP},
            "sampling": {"k": SAMPLE_K, "inv_temp": SAMPLE_INV_TEMP},
            "top_k": "exact in every configuration (the port has no approximate top-k)",
            "rule": f"round trip >= fp32's - {RT_GAP} on each split, TV <= {TV_MAX}",
            "results": results, "verdict": verdict,
            "ok": all(v["ok"] for v in verdict.values())}


def quality_vs_fp32(production: dict, fp32: dict, record: dict) -> dict:
    """Part 2's comparison: the production setting's generation-quality
    numbers beside float32's from the same run (fraction valid and unique
    within QUALITY_BAND) and beside the record's."""
    def numbers(q):
        b = q["bulk"]
        return {"greedy_roundtrip_train": q["greedy_roundtrip_train"],
                "greedy_roundtrip_holdout": q["greedy_roundtrip_holdout"],
                "fraction_valid": b["fraction_valid"], "fraction_unique": b["fraction_unique"],
                "mean_len": b["mean_len"]}

    prod, ref, rec = numbers(production), numbers(fp32), numbers(record)
    rows = {}
    for key, value in prod.items():
        rows[key] = {"production": value, "fp32": ref[key], "diff": value - ref[key],
                     "record": rec[key], "diff_record": value - rec[key]}
        if key in ("fraction_valid", "fraction_unique"):
            rows[key]["band"] = QUALITY_BAND
            rows[key]["ok"] = abs(value - ref[key]) <= QUALITY_BAND
    return {"n_samples": production["bulk"]["n_samples"], "numbers": rows,
            "ok": all(r.get("ok", True) for r in rows.values())}


def production_quality(doc, corpus, device=None, **quality) -> dict:
    """chembl_analysis.generation_quality on the `default` configuration."""
    base, tok = load_e3gnn_smiles_clip_e2e(str(doc), device=device)
    model = COATI(base.params, base.config.replace(**dict(CONFIGS)["default"]), seed=0)
    return generation_quality(model, tok, str(corpus), **{**QUALITY, **quality})


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi: failed"


def device_name(device=None) -> str:
    """The card's name, or the device asked for."""
    device = resolve_device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc", default=str(DOC))
    parser.add_argument("--corpus", default=str(CORPUS))
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--rt_sample", type=int, default=QUALITY["rt_sample"],
                        help="round-trip rows per split, in both parts")
    parser.add_argument("--sample_b", type=int, default=1024)
    parser.add_argument("--batches", type=int, default=QUALITY["batches"])
    parser.add_argument("--batch_size", type=int, default=QUALITY["batch_size"])
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    decode = evaluate(args.doc, args.corpus, args.rt_sample, args.sample_b, args.device)
    sizes = dict(rt_sample=args.rt_sample, batches=args.batches, batch_size=args.batch_size)
    base, tok = load_e3gnn_smiles_clip_e2e(args.doc, device=args.device)
    fp32 = generation_quality(base, tok, args.corpus, **{**QUALITY, **sizes})
    del base
    prod = production_quality(args.doc, args.corpus, args.device, **sizes)
    quality = quality_vs_fp32(prod, fp32, json.loads(RECORD.read_text()))
    quality.update({"setting": dict(CONFIGS)["default"], **QUALITY, **sizes})
    out = {"card": card_line(), "device": device_name(args.device),
           "decode_configurations": decode, "generation_quality": quality,
           "seconds": time.perf_counter() - started,
           "ok": decode["ok"] and quality["ok"]}
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(json.dumps({k: out[k] for k in ("card", "ok", "seconds")}))
    print(f"verdict ok={out['ok']} -> {args.out}")
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
