"""Multiprocess host-side batch transformation.

Counterpart of coati_tpu/data/host_workers.py: `XformWorkerPool` applies
clip_ar_xform (canonicalize, permute, tokenize) to raw stacked batches in
worker processes, so that one core's transform does not hold the card.
Each worker builds its tokenizer once and reuses it.

    with XformWorkerPool(vocab_name="mar", n_seq=80,
                         xform_kwargs=dict(p_clip=0.9, ...)) as pool:
        for batch in pool.map(raw_batches):   # raw stacked batches in,
            train_step(batch)                 # transformed batches out, in order

Two things differ from coati_tpu's pool, which has them as faults:
  * `map` keeps at most `read_ahead` + `n_workers` batches in flight (one
    in the hands of each worker, `read_ahead` queued behind them): it
    submits a batch only when fewer are pending, so the input iterator is
    read no further ahead than that (Pool.imap's feeder thread drains it
    whole);
  * each worker seeds the global `random` and numpy modules as well as its
    own generator from seed + pid. permute_smiles draws from the global
    `random`, and forked workers would otherwise all inherit the parent's
    state and permute alike.

Workers are forked, as in coati_tpu. Batches cross processes as numpy
arrays and Python objects; the workers touch neither torch tensors nor the
card, so a parent that has initialized CUDA may fork them.
"""

from __future__ import annotations

import collections
import multiprocessing as mp
from typing import Dict, Iterable, Iterator, Optional

_WORKER_STATE: dict = {}


def _worker_init(vocab_name: str, n_seq: int, xform_kwargs: dict, seed: int):
    import random

    import numpy as np

    from coati_tpu_torch.data.xform import clip_ar_xform
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    tokenizer = TrieTokenizer(n_seq=n_seq, **get_vocab(vocab_name))
    worker_seed = seed + mp.current_process().pid
    random.seed(worker_seed)
    np.random.seed(worker_seed % 2**32)
    rng = random.Random(worker_seed)
    _WORKER_STATE["fn"] = lambda batch: clip_ar_xform(
        batch, tokenizer=tokenizer, rng=rng, **xform_kwargs
    )


def _worker_apply(batch: Dict) -> Dict:
    return _WORKER_STATE["fn"](batch)


class XformWorkerPool:
    """Applies clip_ar_xform to raw stacked batches in worker processes.
    `peak_in_flight` is the most batches `map` has had submitted and not
    yet handed on."""

    def __init__(
        self,
        vocab_name: str,
        n_seq: int,
        xform_kwargs: Optional[dict] = None,
        n_workers: Optional[int] = None,
        read_ahead: int = 4,
        seed: int = 0,
    ):
        if read_ahead < 1:
            raise ValueError(f"read_ahead must be at least 1, got {read_ahead}")
        self.n_workers = n_workers or max(1, (mp.cpu_count() or 4) - 2)
        self.read_ahead = read_ahead
        self.peak_in_flight = 0
        ctx = mp.get_context("fork")
        self._pool = ctx.Pool(
            self.n_workers,
            initializer=_worker_init,
            initargs=(vocab_name, n_seq, xform_kwargs or {}, seed),
        )

    def map(self, raw_batches: Iterable[Dict]) -> Iterator[Dict]:
        """Ordered streaming map with at most `read_ahead` + `n_workers`
        batches in flight, so that every worker has a batch while
        `read_ahead` more wait. A worker's exception is raised here, at its
        batch."""
        pending: collections.deque = collections.deque()
        cap = self.read_ahead + self.n_workers
        for batch in raw_batches:
            pending.append(self._pool.apply_async(_worker_apply, (batch,)))
            self.peak_in_flight = max(self.peak_in_flight, len(pending))
            if len(pending) >= cap:
                yield pending.popleft().get()
        while pending:
            yield pending.popleft().get()

    def close(self):
        self._pool.close()
        self._pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
