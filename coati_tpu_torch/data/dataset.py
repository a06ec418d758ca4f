"""COATI pretraining dataset: a local cache of pickle shards of the public
corpus.

Counterpart of coati_tpu/data/dataset.py (itself the reference's
COATI_dataset). The md5-mod partition split is kept byte for byte: it
defines the train / valid / test membership of every published artifact.
Shards are read in an order drawn from `shuffle_seed`, their rows pass a
bounded shuffle buffer drawn from the same numpy Generator, and then the
batching loop of data/batch_pipe.py. `prefetch` runs any iterator in a
background thread so that the host pipeline overlaps the card's step.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from coati_tpu_torch.common.util import dir_or_file_exists, makedir, query_yes_no
from coati_tpu_torch.data.batch_pipe import batch_rows, shuffle_buffer, unstack_pickles

S3_PATH = "datasets/coati_data/"


class COATI_dataset:
    def __init__(
        self,
        cache_dir: str,
        fields: List[str] = ["smiles", "atoms", "coords"],
        test_split_mode: str = "row",
        test_frac: float = 0.02,
        valid_frac: float = 0.02,
    ):
        self.cache_dir = cache_dir
        self.summary = {"dataset_type": "coati", "fields": fields}
        self.fields = fields
        self.test_frac = test_frac
        self.valid_frac = valid_frac
        if not (0 <= int(test_frac * 100) <= 50 and 0 <= int(valid_frac * 100) <= 50
                and int(valid_frac * 100 + test_frac * 100) < 50):
            raise ValueError(f"test_frac {test_frac} and valid_frac {valid_frac} must each be "
                             "at most 0.5 and together under 0.5")
        self.test_split_mode = test_split_mode

    def partition_routine(self, row: Dict) -> List[str]:
        if "mod_molecule" not in row:
            return ["raw", "train"]
        out = ["raw"]
        mod = row["mod_molecule"] % 100
        if mod >= int((self.test_frac + self.valid_frac) * 100):
            out.append("train")
        elif mod >= int(self.test_frac * 100):
            out.append("valid")
        else:
            out.append("test")
        return out

    def shard_paths(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.cache_dir, S3_PATH, "*.pkl")))

    def ensure_cache(self, rebuild: bool = False) -> None:
        """Nothing when the first shard is there; else ask, then mirror the
        public bucket (which needs boto3) into the cache directory."""
        if dir_or_file_exists(os.path.join(self.cache_dir, S3_PATH, "0.pkl")) and not rebuild:
            return
        makedir(self.cache_dir)
        if not query_yes_no(
            f"Will download ~340 GB of data to {self.cache_dir} . "
            "This will take a while. Are you sure?"
        ):
            raise FileNotFoundError(
                f"no shards under {os.path.join(self.cache_dir, S3_PATH)}, and the download "
                "was declined"
            )
        from coati_tpu_torch.common.artifacts import copy_bucket_dir_from_s3

        copy_bucket_dir_from_s3(S3_PATH, self.cache_dir)

    def get_data_pipe(
        self,
        rebuild: bool = False,
        batch_size: int = 32,
        partition: str = "raw",
        required_fields: List[str] = [],
        distributed_rankmod_total: Optional[int] = None,
        distributed_rankmod_rank: int = 1,
        xform_routine: Callable = lambda x: x,
        shuffle_seed: Optional[int] = None,
        row_buffer: int = 200_000,
    ) -> Iterator[Dict]:
        """Shard files -> shuffled rows -> hash-sharded, partitioned,
        stacked, transformed batches. Rows must hold every field of
        `self.fields` (`required_fields` is accepted for the trainers'
        call and not used, as in coati_tpu)."""
        print(f"trying to open a {partition} datapipe for...")
        self.ensure_cache(rebuild)
        rng = np.random.default_rng(shuffle_seed)
        paths = self.shard_paths()
        order = rng.permutation(len(paths))
        shuffled_paths = [paths[i] for i in order]

        def rows() -> Iterator[Dict]:
            for shard_rows in unstack_pickles(shuffled_paths):
                yield from shard_rows

        return batch_rows(
            shuffle_buffer(rows(), row_buffer, rng),
            batch_size=batch_size,
            partition=partition,
            xform_routine=xform_routine,
            partition_routine=self.partition_routine,
            distributed_rankmod_total=distributed_rankmod_total,
            distributed_rankmod_rank=distributed_rankmod_rank,
            required_fields=self.fields,
            # few distinct atom widths, so the message kernels see few N
            pad_to_bucket=True,
        )


def prefetch(iterator: Iterator, depth: int = 4) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so that
    the host pipeline overlaps the card's work. An exception of the
    iterator is raised again in the consumer: a corrupt shard fails the
    epoch instead of ending it early."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(end)
        except BaseException as ex:  # noqa: BLE001 - handed to the consumer, which raises it
            q.put(ex)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is end:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
