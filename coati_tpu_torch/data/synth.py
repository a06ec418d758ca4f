"""Synthesized-corpus dataset: rows of SMILES with precomputed conformers.

Own copy of coati_tpu/data/synth.py (numpy only). `SynthCorpusDataset`
serves rows from an in-memory corpus:

  * rows carry ``smiles`` plus, where the conformer map has the molecule,
    precomputed ``atoms``/``coords``, like reference dataset rows, so the
    training xform does not embed conformers per row;
  * sampling is without replacement in shuffled whole-corpus passes,
    truncated to whole batches so no batch straddles two passes (a molecule
    twice in one batch is a false negative of the InfoNCE loss);
  * `split()` gives a deterministic train/holdout partition (one seeded
    permutation).

The pipe contract is that of the reference's COATI_dataset.get_data_pipe, so
train_autoencoder consumes it unchanged.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["SynthCorpusDataset", "load_corpus", "load_conformer_sidecar"]


def load_corpus(path: str) -> List[str]:
    """One canonical SMILES per line; .gz transparently."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return [ln.strip() for ln in f if ln.strip()]


def load_conformer_sidecar(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """smiles -> (atoms int32 (N,), coords float32 (N,3)); rows whose
    embedding failed (stored empty) are omitted so the xform's own
    fallback handles them."""
    with np.load(path, allow_pickle=True) as z:
        smiles = z["smiles"]
        atoms = z["atoms"]
        coords = z["coords"]
    out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for s, a, c in zip(smiles, atoms, coords):
        if a.shape[0]:
            out[str(s)] = (np.asarray(a, np.int32), np.asarray(c, np.float32))
    return out


class SynthCorpusDataset:
    """In-memory corpus with optional precomputed-conformer columns.

    Parameters
    ----------
    smiles : corpus rows (already canonical).
    epoch_rows : rows one epoch yields (train_autoencoder consumes
        epochs; reference COATI_dataset epochs are shard-sized).
    conformers : smiles -> (atoms, coords) map; rows found here carry the
        columns, others stay SMILES-only (which the port's xform refuses
        until it has a conformer embedder).
    collection : source_collection tag rows carry (conditions the [SET]
        token like the reference's dataset collections).
    """

    def __init__(
        self,
        smiles: Sequence[str],
        epoch_rows: int,
        conformers: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]] = None,
        collection: str = "chembl_mols",
        seed: int = 0,
    ):
        self.smiles = list(smiles)
        self.epoch_rows = epoch_rows
        self.conformers = conformers or {}
        self.collection = collection
        self.seed = seed
        self.summary = {
            "dataset_type": "synth_corpus",
            "n_molecules": len(self.smiles),
            "n_with_conformers": sum(
                1 for s in self.smiles if s in self.conformers
            ),
        }

    @classmethod
    def from_files(
        cls,
        corpus_path: str,
        epoch_rows: int,
        conformers_path: Optional[str] = None,
        **kw,
    ) -> "SynthCorpusDataset":
        conf = None
        if conformers_path and os.path.exists(conformers_path):
            conf = load_conformer_sidecar(conformers_path)
        return cls(load_corpus(corpus_path), epoch_rows, conformers=conf, **kw)

    def split(self, holdout_frac: float = 0.1, seed: int = 20260819
              ) -> Tuple[List[str], List[str]]:
        """Deterministic (train, holdout) partition."""
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.smiles))
        n_hold = max(1, int(len(self.smiles) * holdout_frac))
        hold = [self.smiles[i] for i in idx[:n_hold]]
        train = [self.smiles[i] for i in idx[n_hold:]]
        return train, hold

    def subset(self, smiles: Sequence[str], epoch_rows: Optional[int] = None
               ) -> "SynthCorpusDataset":
        """Same sidecar, restricted corpus (e.g. the train split)."""
        return SynthCorpusDataset(
            smiles,
            epoch_rows if epoch_rows is not None else self.epoch_rows,
            conformers=self.conformers,
            collection=self.collection,
            seed=self.seed,
        )

    def get_data_pipe(
        self,
        batch_size: int = 8,
        partition: str = "train",
        required_fields: Sequence[str] = (),
        xform_routine=lambda x: x,
        distributed_rankmod_total: Optional[int] = None,
        distributed_rankmod_rank: int = 1,
        **kw,
    ) -> Iterator[Dict]:
        from coati_tpu_torch.data.batch_pipe import batch_rows

        rng = np.random.default_rng(self.seed if partition == "train"
                                    else self.seed + 1)
        smiles = self.smiles
        # whole-batch shuffled passes (no straddling — class docstring)
        per_pass = max(len(smiles) // batch_size, 1) * batch_size

        def rows() -> Iterator[Dict]:
            order: List[int] = []
            for _ in range(self.epoch_rows):
                if not order:
                    order = list(rng.permutation(len(smiles))[:per_pass])
                s = smiles[order.pop()]
                row: Dict = {"smiles": s,
                             "source_collection": self.collection}
                conf = self.conformers.get(s)
                if conf is not None:
                    row["atoms"], row["coords"] = conf
                yield row

        return batch_rows(
            rows(), batch_size=batch_size, partition="raw",
            xform_routine=xform_routine, required_fields=["smiles"],
            # atoms pad to one of a few bucket sizes, as in the JAX package
            pad_to_bucket=True,
            distributed_rankmod_total=distributed_rankmod_total,
            distributed_rankmod_rank=distributed_rankmod_rank,
        )
