"""LoRA fine-tuning workflow: adapt a trained COATI document to a new
molecule corpus without touching the base weights.

1. Load a model document.
2. Attach rank-r adapters over the transformer trunk (no change at init).
3. Fine-tune the AR objective on your SMILES corpus; only the adapters train.
4. Merge the adapters and save a plain model document any loader accepts.

Run:
    python -m coati_tpu_torch.examples.finetune_lora --doc_url <model document> \
        [--smiles_file corpus.txt] [--rank 8] [--steps 500] [--out tuned.pkl]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.models.io import (
    load_e3gnn_smiles_clip_e2e,
    load_model_doc,
    model_to_state,
    serialize_model,
)
from coati_tpu_torch.training.finetune import init_lora, make_lora_ar_step, merged_model

DEFAULT_CORPUS = [
    "CCO", "CCN", "CCC", "CC(C)O", "CC(N)C(=O)O", "c1ccccc1O",
    "CC(=O)NC", "CCOC(=O)C", "NCCO", "CC(C)(C)O",
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--doc_url", required=True)
    ap.add_argument("--smiles_file", default=None)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--alpha", type=float, default=16.0)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--out", default="coati_lora_tuned.pkl")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    args = ap.parse_args(argv)

    model, tok = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)
    corpus = DEFAULT_CORPUS
    if args.smiles_file:
        with open(args.smiles_file) as f:
            corpus = [line.strip() for line in f if line.strip()]
    print(f"fine-tuning on {len(corpus)} molecules, rank {args.rank}")

    rows = []
    for s in corpus:
        try:
            rows.append(tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True))
        except KeyError as ex:
            print(f"skipping untokenizable {s!r}: {ex}")
    rows = np.asarray(rows, np.int64)
    y_next = np.zeros_like(rows)
    y_next[:, :-1] = rows[:, 1:]
    y_next[y_next == tok.pad_token] = -1

    xf = model.params.xformer
    cfg = model.config.xformer_config
    lora = init_lora(torch.Generator(device=model.device).manual_seed(0), xf,
                     rank=args.rank, alpha=args.alpha)
    step = make_lora_ar_step(xf, cfg, torch.optim.Adam(lora.parameters(), lr=args.lr))

    rng = np.random.default_rng(0)
    losses = []
    for i in range(args.steps):
        idx = rng.integers(0, len(rows), size=min(args.batch_size, len(rows)))
        losses.append(float(step(lora, rows[idx], y_next[idx])))
        if i % max(1, args.steps // 10) == 0:
            print(f"step {i}: ar loss {losses[-1]:.4f}")

    # the source document's envelope, so every loader reads the tuned one
    src_doc = load_model_doc(args.doc_url)
    train_args = dict(src_doc.get("train_args", {}))
    train_args.update({"lora_rank": args.rank, "lora_alpha": args.alpha})
    doc = serialize_model(
        train_args=train_args,
        dataset_summary={"finetune_corpus_size": len(rows)},
        model_state=model_to_state(merged_model(model.params, lora)),
        model_kwargs=dict(src_doc["model_kwargs"]),
    )
    with open(args.out, "wb") as f:
        f.write(doc)
    print(f"merged document written to {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB)")
    return {"rows": len(rows), "losses": losses, "out": args.out, "lora": lora}


if __name__ == "__main__":
    main()
