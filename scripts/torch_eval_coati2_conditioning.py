#!/usr/bin/env python3
"""COATI2's property-conditioning efficacy on the port (coati_tpu_torch): the
protocol of scripts/eval_coati2_conditioning.py.

    python3 scripts/torch_eval_coati2_conditioning.py [--out docs/torch_eval_coati2_conditioning.json]
                                                      [--device cpu]

Runs on the CUDA card unless --device names another. Imports torch and
coati_tpu_torch only. EVAL_STEPS in the environment sets the number of
training steps (default 3,000).

A small COATI2 (3 x 96, 4 heads, n_seq 48, directCLR over 16 dimensions,
float32) is trained from seeded weights by the port's step
(make_coati2_train_step, ClippedAdamW at lr 2e-3 and weight decay 1e-3) on
batches of 64 rows made by coati2_ar_xform (p_props 0.9, p_prop_each 1.0,
p_clip 0.5) from a corpus in which one property is the molecule's size:
unbranched C/N/O chains of 4 to 16 atoms, whose [NumRotatableBonds] column
carries the atom count (the SMILES length). Then 64 chains are generated
behind '[PROPS][NumRotatableBonds][NUM<n>][ENDPROPS][SMILES]' for n in 5,
8, 11, 14 (generate_prefix_batch, k 4, inverse temperature 2), with no
embedding injected. The mean length of the clean chains must rise with n:
the verdict is ok when the four means increase and their correlation with
n is at least 0.9. main writes the verdict, with the card's name and power
limit and the attention kernels' launches, to --out and exits non-zero
unless it holds.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_eval_trained_decode import card_line, device_name  # noqa: E402

from coati_tpu_torch.common.util import resolve_device  # noqa: E402
from coati_tpu_torch.data.xform_coati2 import coati2_ar_xform  # noqa: E402
from coati_tpu_torch.examples import DEVICE_HELP  # noqa: E402
from coati_tpu_torch.models.sampler import generate_prefix_batch  # noqa: E402
from coati_tpu_torch.ops.kernels.decode_attention import (  # noqa: E402
    decode_attention,
    decode_attention_quant,
)
from coati_tpu_torch.ops.kernels.flash_attention import flash_causal_attention  # noqa: E402
from coati_tpu_torch.ops.kernels.packed_attention import packed_causal_attention  # noqa: E402
from coati_tpu_torch.tokenizers import get_vocab  # noqa: E402
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer  # noqa: E402
from coati_tpu_torch.training.config import TrainConfig  # noqa: E402
from coati_tpu_torch.training.train import make_optimizer  # noqa: E402
from coati_tpu_torch.training.train_coati2 import (  # noqa: E402
    Coati2TrainConfig,
    batch_to_device,
    fresh_model,
    make_coati2_train_step,
)

OUT = ROOT / "docs" / "torch_eval_coati2_conditioning.json"
TARGETS = (5, 8, 11, 14)
N_SAMPLES = 64
BATCH = 64
MIN_CORRELATION = 0.9


def make_corpus(n_per_len: int = 24, lengths=range(4, 17)):
    """Unbranched C/N/O chains: heavy-atom count == len(smiles)."""
    rng = np.random.default_rng(0)
    atoms = ["C", "N", "O"]
    corpus = []
    for length in lengths:
        seen = set()
        while len(seen) < n_per_len:
            s = "C" + "".join(atoms[rng.integers(0, 3)] for _ in range(length - 1))
            seen.add(s)
        corpus.extend(sorted(seen))
    return corpus


def conditioned_lengths(model, model_cfg, tok, device) -> dict:
    """{n: (mean length, clean chains)} of N_SAMPLES chains generated
    behind the [NumRotatableBonds][NUM<n>] block, for each n of TARGETS."""
    out = {}
    for target in TARGETS:
        prefix = tok.tokenize_text(
            f"[PROPS][NumRotatableBonds][NUM{target}][ENDPROPS][SMILES]", pad=False)
        generator = torch.Generator(device=device).manual_seed(100 + target)
        rows = generate_prefix_batch(
            model.xformer, model_cfg.xformer_config, generator, [prefix] * N_SAMPLES,
            stop_token=tok.stop_token, pad_token=tok.pad_token, k=4, inv_temp=2.0,
        ).cpu().numpy()
        decoded = [tok.decode(list(r), special=False) for r in rows]
        lengths = [len(s) for s in decoded if s and set(s) <= set("CNO")]
        out[target] = (float(np.mean(lengths)) if lengths else float("nan"), len(lengths))
        print(f"  NUM{target}: mean length {out[target][0]:.2f} "
              f"({len(lengths)}/{N_SAMPLES} clean chains)")
    return out


def launches() -> dict:
    """Each attention kernel's launches in this process (0 off the card)."""
    counts = {f.__name__: f.launches for f in (flash_causal_attention, decode_attention,
                                               decode_attention_quant, packed_causal_attention)}
    counts["packed_causal_attention_backward"] = packed_causal_attention.bwd_launches
    return counts


def verdict(means: dict) -> dict:
    """Monotone increase of the means over TARGETS and their correlation
    with the targets; ok when monotone and the correlation >= 0.9."""
    targets = sorted(means)
    values = [means[t] for t in targets]
    monotone = all(a < b for a, b in zip(values, values[1:]))
    corr = float(np.corrcoef(targets, values)[0, 1])
    return {"monotone": monotone, "correlation": corr,
            "ok": bool(monotone and corr >= MIN_CORRELATION)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(OUT))
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    n_steps = int(os.environ.get("EVAL_STEPS", 3000))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    corpus = make_corpus()
    print(f"corpus: {len(corpus)} chains, lengths 4-16")

    tok = TrieTokenizer(n_seq=48, **get_vocab("coati2_12_12"))
    config = Coati2TrainConfig(
        n_layer_xformer=3, n_hidden_xformer=96, embed_dim=96, n_head=4, n_seq=48,
        n_direct_clr=16, p_props=0.9, p_prop_each=1.0,
        # half the rows carry no [CLIP][UNK] injection: with the embedding
        # always there, the property tokens are redundant and ignored
        p_clip=0.5, lr=2e-3, remat=False,
    )
    model_cfg = config.model_config(tok.n_token)
    model = fresh_model(model_cfg, device, seed=0)
    model.train()
    optimizer = make_optimizer(TrainConfig(lr=config.lr, weight_decay=1e-3), model)
    step = make_coati2_train_step(
        model, model_cfg, optimizer, stop_token=tok.stop_token, unk_token=tok.unk_token,
        pad_token=tok.pad_token, token_entropy_unit=float(np.log2(tok.n_token)),
        do_clr=True, clr_inv_temp=config.clr_inv_temp,
    )

    rng_py = random.Random(0)
    np_rng = np.random.default_rng(2)
    start = time.perf_counter()
    losses = []
    for i in range(n_steps):
        idx = np_rng.integers(0, len(corpus), size=BATCH)
        rows = [corpus[j] for j in idx]
        batch = coati2_ar_xform(
            # the conditioning channel: the atom count as NumRotatableBonds
            {"smiles": rows, "properties": [{"NumRotatableBonds": len(s)} for s in rows]},
            tok, p_props=config.p_props, p_prop_each=config.p_prop_each,
            p_clip=config.p_clip, rng=rng_py,
        )
        metrics = step(batch_to_device(batch, device))
        if i % 500 == 0 or i == n_steps - 1:
            losses.append((i, float(metrics["loss"])))
            print(f"step {i}: loss {losses[-1][1]:.4f} ({time.perf_counter() - start:.0f}s)")
    train_s = time.perf_counter() - start

    print("prefix-conditioned generation (target -> mean generated length):")
    model.eval()
    start = time.perf_counter()
    with torch.no_grad():
        lengths = conditioned_lengths(model, model_cfg, tok, device)
    generate_s = time.perf_counter() - start
    out = verdict({t: m for t, (m, _) in lengths.items()})
    print(f"length/target correlation: {out['correlation']:.3f} "
          f"(monotone: {out['monotone']})")
    out = {"card": card_line(),
           "device": device_name(device),
           "mean_length": {str(t): m for t, (m, _) in lengths.items()},
           "clean_chains": {str(t): n for t, (_, n) in lengths.items()},
           "samples_per_target": N_SAMPLES, **out,
           "final_loss": losses[-1][1], "losses": losses, "steps": n_steps,
           "train_seconds": train_s, "generate_seconds": generate_s,
           "seconds": train_s + generate_s, "launches": launches()}
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    print(f"verdict ok={out['ok']} -> {args.out}")
    return out


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
