"""Tutorial workflow (script form of the reference's tutorial notebook).

1. Load a COATI model document.
2. Embed a SMILES batch -> fixed-dimension vectors.
3. Decode vectors back to molecules (round trip).
4. Generate "nearby" molecules with noised embeddings.
5. Regress a property from embeddings (RandomForest on QED; only where
   RDKit and scikit-learn import).

Run:
    python -m coati_tpu_torch.examples.tutorial --doc_url <model document> [--smiles_file f]
"""

from __future__ import annotations

import argparse

import numpy as np

from coati_tpu_torch.chem.rdkit_support import HAS_RDKIT, canonicalize_or_self, is_valid_smiles
from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.generative.purifications import embed_smiles_batch
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

DEFAULT_SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--doc_url", required=True, help="model document path")
    parser.add_argument("--smiles_file", default=None)
    parser.add_argument("--n_analogs", type=int, default=16)
    parser.add_argument("--noise_scale", type=float, default=0.3)
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    model, tokenizer = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)

    smiles = DEFAULT_SMILES
    if args.smiles_file:
        with open(args.smiles_file) as f:
            smiles = [line.strip() for line in f if line.strip()]
    smiles = [canonicalize_or_self(s) for s in smiles]

    # 2. embed
    embeds = embed_smiles_batch(smiles, model, tokenizer)
    print(f"embedded {len(smiles)} molecules -> {embeds.shape}")

    # 3. round trip
    decoded = model.hclip_to_2d_batch(embeds, tokenizer, inv_temp=2.0, k=100)
    exact = sum(canonicalize_or_self(d) == s for d, s in zip(decoded, smiles))
    print(f"round-trip exact matches: {exact}/{len(smiles)}")
    for s, d in zip(smiles[:4], decoded[:4]):
        print(f"   {s}  ->  {d}")

    # 4. noised analogs of the first molecule
    analogs = model.hclip_to_2d_batch(
        np.tile(embeds[0:1], (args.n_analogs, 1)),
        tokenizer,
        noise_scale=args.noise_scale,
        inv_temp=2.0,
        k=100,
    )
    valid = [a for a in analogs if is_valid_smiles(a)]
    print(
        f"noisy analogs of {smiles[0]}: {len(valid)}/{args.n_analogs} valid, "
        f"{len(set(valid))} unique"
    )
    out = {"smiles": smiles, "embeddings": embeds, "decoded": decoded,
           "round_trip_exact": exact, "analogs": analogs, "analogs_valid": len(valid),
           "analogs_unique": len(set(valid))}

    # 5. embedding -> property regression (QED, where RDKit is present)
    if HAS_RDKIT and len(smiles) >= 6:
        from rdkit import Chem
        from rdkit.Chem import QED
        from sklearn.ensemble import RandomForestRegressor

        y = np.array([QED.qed(Chem.MolFromSmiles(s)) for s in smiles])
        reg = RandomForestRegressor(n_estimators=50).fit(embeds, y)
        out["qed_r2_train"] = reg.score(embeds, y)
        print("QED regression R^2 (train):", out["qed_r2_train"])
    return out


if __name__ == "__main__":
    main()
