"""Molecular-graph serialization to token strings (TokenGT-style).

Parity target: coati/models/encoding/fill_in_middle.py:6-75
(adj_mat_to_tokens). Produces
'[GRAPH][NUMi][ELMz]...[EDGES][EDGE?][NUMa][NUMb]...' strings used by the
p_graph training augmentation.
"""

from __future__ import annotations

import numpy as np


def adj_mat_to_tokens(
    adj_mat: np.ndarray, adj_mat_atoms: np.ndarray, only_heavy: bool = True
) -> str:
    adj_mat_atoms = np.asarray(adj_mat_atoms)
    if np.isnan(adj_mat_atoms.astype(float)).any():
        return ""
    if (adj_mat_atoms > 1).sum() > 150:
        return ""

    # heavy atoms get compact consecutive indices
    light_to_heavy = np.zeros(adj_mat_atoms.shape[0], dtype=int)
    light_to_heavy[adj_mat_atoms > 1] = np.arange((adj_mat_atoms > 1).sum(), dtype=int)

    atom_parts = []
    for i, z in enumerate(adj_mat_atoms):
        if only_heavy and z < 2:
            continue
        atom_parts.append(f"[NUM{light_to_heavy[i]}][ELM{int(z)}]")

    edge_parts = []
    for edge in np.asarray(adj_mat):
        a, b, order = int(edge[0]), int(edge[1]), float(edge[2])
        if only_heavy and (adj_mat_atoms[a] < 2 or adj_mat_atoms[b] < 2):
            continue
        if order == 1:
            et = "[EDGE1]"
        elif 1 < order < 2:
            et = "[EDGEC]"
        elif int(order) == 2:
            et = "[EDGE2]"
        elif int(order) == 3:
            et = "[EDGE3]"
        else:
            et = "[EDGE0]"
        lo, hi = sorted((light_to_heavy[a], light_to_heavy[b]))
        edge_parts.append(f"{et}[NUM{lo}][NUM{hi}]")

    return "[GRAPH]" + "".join(atom_parts) + "[EDGES]" + "".join(edge_parts)
