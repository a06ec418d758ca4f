"""Host-side batching pipeline.

Own copy of coati_tpu/data/batch_pipe.py (numpy only): a plain-Python
generator pipeline with the reference's semantics, which define train/test
membership of every published artifact:

  * md5(smiles) % 100_000 row hashing;
  * rank sharding by mod % world_size == rank;
  * stack_batch pads ragged atoms/coords to the batch max;
  * partition routine filtering, required-field filtering, batch
    assembly, optional xform routine.

`pad_to_bucket` rounds the atom dimension up to a small set of bucket
sizes, so that the message kernels see few distinct N. The JAX package's
readers of pickled shards (unstack_pickles, shuffle_buffer) come with the
dataset loader that uses them.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

ATOM_BUCKETS = (16, 32, 48, 64, 96, 128, 160, 200, 256)


def get_mod_from_str(x: str, divisor: int = 100_000) -> int:
    return int.from_bytes(hashlib.md5(x.encode("utf-8")).digest(), "little") % divisor


def bucket_atoms(n: int, buckets: Sequence[int] = ATOM_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return n


def stack_batch(
    rows: List[Dict],
    return_coords: bool = True,
    return_grads: bool = False,
    return_dipole: bool = False,
    pad_to_bucket: bool = False,
) -> Dict:
    """Stack a list of row dicts into a column dict; atoms/coords are
    padded to the batch max (optionally rounded up to a bucket size)."""
    batch: Dict = {}
    if return_coords:
        nrows = len(rows)
        natoms = [r["atoms"].shape[0] if "atoms" in r else 0 for r in rows]
        max_atoms = int(np.max(natoms)) if natoms else 0
        if pad_to_bucket:
            max_atoms = bucket_atoms(max_atoms)
        atoms = np.zeros((nrows, max_atoms))
        coords = np.zeros((nrows, max_atoms, 3))
        grads = np.zeros((nrows, max_atoms, 3)) if return_grads else None
        dipoles = np.zeros((nrows, 3)) if return_dipole else None
        for i, row in enumerate(rows):
            if "atoms" not in row:
                continue
            ra, rc = row["atoms"], row["coords"]
            atoms[i, : ra.shape[0]] = ra
            try:
                coords[i, : rc.shape[0], :] = rc
            except (ValueError, IndexError):
                # flat-coordinate rows (reference's "snowflake" hack)
                rc = np.asarray(rc).reshape((-1, 3), order="C")
                coords[i, : rc.shape[0], :] = rc
            if return_grads and "gradients" in row:
                g = row["gradients"]
                grads[i, : g.shape[0], :] = g
            if return_dipole and "dipole" in row:
                dipoles[i, :] = row["dipole"]
        batch.update({"atoms": atoms, "coords": coords})
        if return_grads:
            batch["gradients"] = grads
        if return_dipole:
            batch["dipoles"] = dipoles

    # carry every other column as an object array
    all_keys: List[str] = []
    for row in rows:
        for k in row:
            if k not in all_keys:
                all_keys.append(k)
    for k in all_keys:
        if k not in batch:
            batch[k] = np.asarray([row.get(k) for row in rows], dtype=object)
    return batch


def default_partition_routine(row: Dict) -> List[str]:
    return ["raw", "train", "test"]


def batch_rows(
    rows: Iterable[Dict],
    batch_size: int = 32,
    partition: str = "raw",
    xform_routine: Callable = lambda x: x,
    partition_routine: Callable = default_partition_routine,
    distributed_rankmod_total: Optional[int] = None,
    distributed_rankmod_rank: int = 1,
    required_fields: Sequence[str] = (),
    skip_last: bool = True,
    pad_to_bucket: bool = False,
) -> Iterator[Dict]:
    """The reference's UrBatcher loop as a plain generator:
    filter -> hash -> shard -> partition -> stack -> xform."""
    batch: List[Dict] = []
    for row in rows:
        if not all(k in row for k in required_fields):
            continue
        row["mod_molecule"] = get_mod_from_str(row["smiles"], 100_000)
        if distributed_rankmod_total is not None:
            if row["mod_molecule"] % distributed_rankmod_total != distributed_rankmod_rank:
                continue
        if partition not in partition_routine(row):
            continue
        batch.append(row)
        if len(batch) == batch_size:
            yield xform_routine(
                stack_batch(batch, return_coords=True, pad_to_bucket=pad_to_bucket)
            )
            batch = []
    if batch and not skip_last:
        yield xform_routine(
            stack_batch(batch, return_coords=True, pad_to_bucket=pad_to_bucket)
        )
