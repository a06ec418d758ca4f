"""Metadynamics multi-parameter optimization (see
coati_tpu_torch/generative/metadynamics.py).

Optimizes molecules for a weighted objective of DUE-predicted endpoints
(e.g. potency + QED) while repulsive Gaussian hills at visited embedding
locations push the walker toward novel chemistry. A DUE model is a
published torch artifact (.pt, converted on load) or a file of this
package's own (DueModel.save). Without one, the demo objective keeps the
walker near the seed.

Run:
    python -m coati_tpu_torch.examples.metadynamics_example --doc_url <model document> \
        --due_qed due_qed.pkl [--due_potency due_pic50.pt] --seed_smiles "CCO..."
"""

from __future__ import annotations

import argparse

import torch

from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.generative.metadynamics import (
    MetadynamicsConfig,
    combined_objective,
    due_objective,
    run_metadynamics,
)
from coati_tpu_torch.generative.purifications import embed_smiles
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from coati_tpu_torch.regression.due_import import load_due


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc_url", required=True)
    parser.add_argument("--seed_smiles", default="CC(=O)Oc1ccccc1C(=O)O")
    parser.add_argument("--due_qed", default=None,
                        help="DUE model (.pt torch artifact or .pkl) for QED")
    parser.add_argument("--due_potency", default=None,
                        help="DUE model (.pt torch artifact or .pkl) for potency")
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--hill_height", type=float, default=1.0)
    parser.add_argument("--hill_width", type=float, default=1.0)
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    model, tokenizer = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)
    v0 = embed_smiles(args.seed_smiles, model, tokenizer)

    terms, weights = [], []
    for path, weight in ((args.due_qed, 1.0), (args.due_potency, 2.0)):
        if path:
            terms.append(due_objective(load_due(path, device=model.device)))
            weights.append(weight)
    if not terms:
        # without DUE models: stay close to the seed (demo objective)
        anchor = torch.as_tensor(v0, device=model.device)
        terms = [lambda v: -0.01 * torch.sum(torch.square(v - anchor.to(v.dtype)))]
        weights = [1.0]

    result = run_metadynamics(
        model,
        tokenizer,
        combined_objective(terms, weights),
        v0,
        MetadynamicsConfig(
            steps=args.steps,
            hill_height=args.hill_height,
            hill_width=args.hill_width,
        ),
    )
    print(f"discovered {len(result.smiles)} unique molecules")
    print("top 10 by objective:")
    top = result.top(10)
    for s, score in top:
        print(f"   {score:8.3f}  {s}")
    return {"n_terms": len(terms), "molecules_found": len(result.smiles), "top": top,
            "best_smiles": result.best_smiles, "best_score": float(result.best_score),
            "history": result.history}


if __name__ == "__main__":
    main()
