"""Generation workflows (script form of the reference's
generation_examples notebook):

  A. prefix-conditioned generation ('[SET][chembl_mols][SMILES]' style);
  B. noisy-embedding analog generation around seed molecules;
  C. a density-sampled virtual screen: fit an embedding-space density,
     sample from it, force-decode valid molecules, and score them with a
     DUE regressor where --due_model is given.

Run: python -m coati_tpu_torch.examples.generation_examples --doc_url <model document>
     [--due_model due.pkl]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self, is_valid_smiles
from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.generative.density import fit_density_closed_form
from coati_tpu_torch.generative.purifications import embed_smiles_batch, force_decode_valid_batch
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

SEEDS = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
    "Clc1ccccc1",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CCN(CC)CCNC(=O)c1ccc(N)cc1",
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc_url", required=True)
    parser.add_argument("--n_bulk", type=int, default=256)
    parser.add_argument("--n_screen", type=int, default=16,
                        help="density draws of the virtual screen")
    parser.add_argument("--due_model", default=None,
                        help="a DueModel saved by regression.due (DueModel.save)")
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    model, tokenizer = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)

    # A. prefix-conditioned bulk generation, validity and uniqueness
    prefix = "[SMILES]"
    if "[chembl_mols]" in tokenizer.special_tokens:
        prefix = "[SET][chembl_mols][SMILES]"
    bulk = model.complete_batch([prefix] * args.n_bulk, tokenizer, inv_temp=1.75, k=1000)
    valid = [canonicalize_or_self(s) for s in bulk if is_valid_smiles(s)]
    print(f"bulk generation: {len(valid)}/{args.n_bulk} valid ({len(set(valid))} unique)")

    # B. noisy analogs
    embeds = embed_smiles_batch(SEEDS, model, tokenizer)
    analogs = model.hclip_to_2d_batch(
        np.repeat(embeds, 8, axis=0), tokenizer, noise_scale=0.25, inv_temp=2.0, k=100
    )
    v = [a for a in analogs if is_valid_smiles(a)]
    print(f"noisy analogs: {len(v)}/{len(analogs)} valid")

    # C. density-sampled virtual screen
    density = fit_density_closed_form(embeds)
    generator = torch.Generator(device=density.mean.device).manual_seed(0)
    samples = density.sample(generator, (args.n_screen,)).float().cpu().numpy()
    screened = [
        force_decode_valid_batch(s, model, tokenizer, batch_size=32, max_attempts=2)
        for s in samples
    ]
    print("virtual-screen candidates:", screened[:8])
    out = {"bulk": bulk, "bulk_valid": len(valid), "bulk_unique": len(set(valid)),
           "analogs": analogs, "analogs_valid": len(v), "embeddings": embeds,
           "density_samples": samples, "screened": screened}

    if args.due_model:
        from coati_tpu_torch.regression.due import DueModel

        due = DueModel.load(args.due_model, device=model.device)
        mean, std = due.predict(embed_smiles_batch(screened, model, tokenizer))
        order = np.argsort(mean)[::-1]
        print("top candidates by DUE score:")
        for i in order[:5]:
            print(f"   {screened[i]}  score {mean[i]:.3f} +- {std[i]:.3f}")
        out.update({"due_mean": mean, "due_std": std})
    return out


if __name__ == "__main__":
    main()
