"""Data files shipped with the port.

points_fixture.npz holds 1,024 molecules of corpora/chembl_synth_v1.smi.gz
as 3D point clouds (written by scripts/make_torch_points_fixture.py with
coati_tpu's conformer embedder, which the port does not have yet).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

POINTS_FIXTURE = Path(__file__).resolve().parent / "points_fixture.npz"


def load_points_fixture() -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(smiles, atoms (B, N) uint8 with 0 = padding, coords (B, N, 3)
    float32); atoms are packed before the padding."""
    with np.load(POINTS_FIXTURE) as z:
        return [str(s) for s in z["smiles"]], z["atoms"], z["coords"]
