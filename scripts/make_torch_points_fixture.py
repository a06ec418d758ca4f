#!/usr/bin/env python3
"""Make coati_tpu_torch/data/points_fixture.npz: 3D point clouds for the
PyTorch port, which has no conformer embedder of its own yet.

    python scripts/make_torch_points_fixture.py [--rows 1024] [--seed 0]

Takes the SMILES of corpora/chembl_synth_v1.smi.gz in the order of a
seeded permutation, embeds each with coati_tpu's offline distance-geometry
embedder (coati_tpu/chem/conformers.py, hydrogens added), keeps the first
`--rows` that embed, and stores, compressed:

    smiles  (B,)       str
    atoms   (B, N)     uint8, atomic numbers, 0 = padding (atoms packed first)
    coords  (B, N, 3)  float32, Angstrom, 0 on padding

N is the atom bucket of coati_tpu/data/batch_pipe.py that holds the
largest molecule. This script is no module of the port: it imports
coati_tpu, the port only reads the file it writes.
"""

from __future__ import annotations

import argparse
import gzip
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from coati_tpu.chem.conformers import embed_smiles_to_atoms_coords  # noqa: E402
from coati_tpu.data.batch_pipe import bucket_atoms  # noqa: E402

CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"
OUT = ROOT / "coati_tpu_torch" / "data" / "points_fixture.npz"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()

    corpus = gzip.open(CORPUS, "rt").read().split()
    order = np.random.default_rng(args.seed).permutation(len(corpus))
    rows, failed = [], 0
    for i in order:
        smiles = corpus[i]
        try:
            atoms, coords = embed_smiles_to_atoms_coords(smiles)
        except Exception:  # noqa: BLE001 - any molecule the embedder refuses is skipped
            failed += 1
            continue
        if not np.isfinite(coords).all():
            failed += 1
            continue
        rows.append((smiles, np.asarray(atoms, np.uint8), np.asarray(coords, np.float32)))
        if len(rows) == args.rows:
            break
    if len(rows) < args.rows:
        print(f"only {len(rows)} of {args.rows} rows embedded", file=sys.stderr)
        return 1

    n = bucket_atoms(max(len(a) for _, a, _ in rows))
    atoms = np.zeros((len(rows), n), np.uint8)
    coords = np.zeros((len(rows), n, 3), np.float32)
    for r, (_, a, x) in enumerate(rows):
        atoms[r, : len(a)] = a
        coords[r, : len(a)] = x
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        args.out, smiles=np.asarray([s for s, _, _ in rows]), atoms=atoms, coords=coords
    )
    counts = (atoms > 0).sum(1)
    print(
        f"{args.out.relative_to(ROOT)}: {len(rows)} rows, N {n}, atoms per molecule "
        f"{counts.min()}-{counts.max()} (mean {counts.mean():.1f}), {failed} skipped, "
        f"{args.out.stat().st_size} bytes"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
