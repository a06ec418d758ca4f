"""Data files shipped with the port.

points_fixture.npz holds 1,024 molecules of corpora/chembl_synth_v1.smi.gz
as 3D point clouds (written by scripts/make_torch_points_fixture.py with
coati_tpu's conformer embedder, which the port does not have yet).
`fixture_dataset` serves them as training rows.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

from coati_tpu_torch.data.synth import SynthCorpusDataset

POINTS_FIXTURE = Path(__file__).resolve().parent / "points_fixture.npz"


def load_points_fixture() -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(smiles, atoms (B, N) uint8 with 0 = padding, coords (B, N, 3)
    float32); atoms are packed before the padding."""
    with np.load(POINTS_FIXTURE) as z:
        return [str(s) for s in z["smiles"]], z["atoms"], z["coords"]


def fixture_dataset(epoch_rows: int, seed: int = 0) -> SynthCorpusDataset:
    """The fixture as a training dataset: its 1,024 SMILES (lines of the
    canonical corpus, so they need no canonicalization) with their atoms and
    coordinates as the conformer map. Atoms are packed before the padding,
    so each row keeps its nonzero prefix."""
    smiles, atoms, coords = load_points_fixture()
    conformers = {}
    for s, a, c in zip(smiles, atoms, coords):
        n = int((a > 0).sum())
        conformers[s] = (a[:n].astype(np.int32), c[:n].astype(np.float32))
    return SynthCorpusDataset(smiles, epoch_rows, conformers=conformers, seed=seed)
