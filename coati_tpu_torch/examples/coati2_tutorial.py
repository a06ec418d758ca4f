"""COATI2 tutorial (script form of the reference's coati2 tutorial
notebook): load a COATI2 document, embed SMILES, decode with noise sweeps,
and run property-token-conditioned generation. The conditioned batch mixes
conditions whose prefixes differ in length: the prefill covers the
shortest, and each longer row is forced through its own prefix.

Run: python -m coati_tpu_torch.examples.coati2_tutorial --doc_url <coati2 document>
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from coati_tpu_torch.chem.rdkit_support import is_valid_smiles
from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.models.io import load_coati2
from coati_tpu_torch.models.sampler import generate_prefix_batch

SEEDS = ["CC(=O)Oc1ccccc1C(=O)O", "CN1C=NC2=C1C(=O)N(C(=O)N2C)C"]
N_CONDITIONED = 8  # rows per property condition
CONDITIONS = (
    "[PROPS][PercentQED][NUM8][ENDPROPS][SMILES]",
    "[PROPS][PercentQED][NUM8][IntMolLogP][NUM3][ENDPROPS][SMILES]",
)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc_url", required=True)
    parser.add_argument("--n_per_noise", type=int, default=16)
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)
    model, tokenizer = load_coati2(args.doc_url, device=args.device)

    vecs = model.smiles_to_coati_vec(SEEDS, tokenizer)
    print(f"embedded -> {vecs.shape}")
    out = {"embeddings": vecs, "noise": {}}

    # noise sweep (the COATI1-vs-2 comparison protocol)
    for noise in (0.0, 0.2, 0.4, 0.6):
        gen = model.hcoati_to_2d_batch(
            np.tile(vecs[:1], (args.n_per_noise, 1)),
            tokenizer,
            noise_scale=noise,
            inv_temp=2.0,
            k=100,
        )
        valid = [g for g in gen if is_valid_smiles(g)]
        out["noise"][noise] = {"valid": len(valid), "unique": len(set(valid))}
        print(
            f"noise {noise:.1f}: {len(valid)}/{args.n_per_noise} valid, "
            f"{len(set(valid))} unique; e.g. {valid[:2]}"
        )

    # property-conditioned generation with COATI2's [PROPS] vocabulary
    if "[PROPS]" in tokenizer.special_tokens:
        prefixes = [tokenizer.tokenize_text(c, pad=False)
                    for c in CONDITIONS for _ in range(N_CONDITIONED)]
        generator = torch.Generator(device=model.device).manual_seed(0)
        tokens = generate_prefix_batch(
            model.params.xformer,
            model.config.xformer_config,
            generator,
            prefixes,
            stop_token=tokenizer.stop_token,
            pad_token=tokenizer.pad_token,
            k=100,
            inv_temp=2.0,
        ).cpu().numpy()
        decoded = [tokenizer.decode(list(r), special=False) for r in tokens]
        out.update({"prefix_lengths": [len(p) for p in prefixes], "conditioned_tokens": tokens,
                    "conditioned": decoded})
        print("property-conditioned samples:", decoded[::N_CONDITIONED])
    return out


if __name__ == "__main__":
    main()
