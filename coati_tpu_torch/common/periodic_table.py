"""Periodic-table data and the point encoder's atom featurization.

The port's own copy of coati_tpu/common/periodic_table.py:
periodic_table.json holds, per element (row z = atomic number, row 0 the
padding element), its properties (`number`, `symbol`, `xpos`, `ypos`,
`atomic_mass`, `cpk-hex`, ...; PERIODIC_PROPERTY reads one). The 28-d
one-hot uses raw xpos / 18+ypos indices; this layout is load-bearing for
published checkpoint weights, keep it. XY_ONE_HOT is the 12-d organic
subset of the reference's tables.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

with open(os.path.join(os.path.dirname(__file__), "periodic_table.json")) as _f:
    PERIODIC_TABLE = json.load(_f)

PERIODIC_MAX_X = max(e["xpos"] for e in PERIODIC_TABLE)
PERIODIC_MAX_Y = max(e["ypos"] for e in PERIODIC_TABLE)
N_XY_FEATURES = PERIODIC_MAX_X + PERIODIC_MAX_Y  # 28


def PERIODIC_PROPERTY(property: str = "cpk-hex"):
    """One property of every element, in atomic-number order."""
    return [e.get(property) for e in PERIODIC_TABLE]


@lru_cache(maxsize=None)
def XY_ONE_HOT_FULL(atomic_number: int):
    """28-d (xpos, 18+ypos) one-hot over the full table."""
    out = [0] * N_XY_FEATURES
    xpos = PERIODIC_TABLE[atomic_number]["xpos"]
    ypos = PERIODIC_TABLE[atomic_number]["ypos"]
    out[xpos] = 1
    # REFERENCE QUIRK (deliberate divergence): the reference's
    # XY_ONE_HOT_FULL (periodic_table.py:3912) raises IndexError for
    # ypos=10 elements (actinides, z=89-103) since 18+10 is out of the
    # 28-wide vector; no published dataset contains them, so we keep the
    # xpos bit and drop the y bit instead of crashing.
    if PERIODIC_MAX_X + ypos < N_XY_FEATURES:
        out[PERIODIC_MAX_X + ypos] = 1
    return out


@lru_cache(maxsize=None)
def xy_one_hot_full_table() -> np.ndarray:
    """(n_elements, 28) float32 lookup table: row z = XY_ONE_HOT_FULL(z).
    Read-only: it is shared between callers."""
    table = np.asarray(
        [XY_ONE_HOT_FULL(z) for z in range(len(PERIODIC_TABLE))], dtype=np.float32
    )
    table.setflags(write=False)
    return table


def atoms_to_xy_features(atoms: np.ndarray) -> np.ndarray:
    """Vectorized featurization: int array of atomic numbers (any shape)
    -> float32 one-hots (shape + (28,)). Padding atoms (z=0) map to the
    'Nullium' row, matching the reference's per-atom loop."""
    return xy_one_hot_full_table()[np.asarray(atoms, dtype=np.int64)]


@lru_cache(maxsize=None)
def XY_ONE_HOT(atomic_number):
    """12-d organic-subset one-hot (zeros for metals and out-of-range);
    takes an atomic number or a symbol."""
    if isinstance(atomic_number, str):
        atomic_number = PERIODIC_PROPERTY("symbol").index(atomic_number)
    out = [0] * 12
    xpos = PERIODIC_TABLE[atomic_number]["xpos"]
    ypos = PERIODIC_TABLE[atomic_number]["ypos"]
    if ypos >= 4 and 2 < xpos < 13:
        return out
    if xpos < 0 or ypos < 0:
        return out
    if xpos > 11:
        xpos -= 11
    try:
        out[ypos - 1] = 1
        out[5 + xpos - 1] = 1
    except IndexError:
        print(f"bad element {atomic_number} :: {xpos}, {ypos}")
    return out


@lru_cache(maxsize=None)
def IS_INORGANIC(atomic_number: int) -> bool:
    return not any(XY_ONE_HOT(atomic_number))


def REVERSE_XY_ONE_HOT(oh):
    """The first atomic number whose XY_ONE_HOT is `oh`."""
    codes = [tuple(XY_ONE_HOT(z)) for z in range(PERIODIC_TABLE[-1]["number"])]
    return codes.index(tuple(oh))


def XYZ_STRING(atoms, coords) -> str:
    """An XYZ-format block of the non-padding atoms."""
    atoms = np.asarray(atoms)
    out = f"{int((atoms > 0).sum())} 0 \n \n"
    for i in range(len(atoms)):
        if int(atoms[i]) > 0:
            sym = PERIODIC_TABLE[int(atoms[i])]["symbol"]
            out += f"{sym} {coords[i, 0]:.5f} {coords[i, 1]:.5f} {coords[i, 2]:.5f} \n"
    return out
