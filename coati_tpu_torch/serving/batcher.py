"""Micro-batching request aggregator.

Counterpart of coati_tpu/serving/batcher.py. Card throughput comes from
batch size (a decode step costs about as much for 1,024 rows as for one),
but serving traffic arrives one request at a time. MicroBatcher sits
between: callers submit items and wait on Futures; one worker thread drains
the queue, packs up to `max_batch` items (waiting at most `flush_ms` after
the first), runs the batch function once, and hands out the results. An
exception of the batch function fails that batch's futures, and the worker
goes on with the next batch.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Sequence


class MicroBatcher:
    def __init__(
        self,
        batch_fn: Callable[[List], Sequence],
        max_batch: int = 256,
        flush_ms: float = 10.0,
        name: str = "batcher",
    ):
        """batch_fn: items -> results (same length, same order)."""
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._flush_s = flush_ms / 1000.0
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._worker.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        # lock closes the check-then-put race with close(): once a
        # submit passes the check its item is enqueued BEFORE close()
        # can flip the flag, so the worker (or close's drain) sees it
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._queue.put((item, fut))
        return fut

    def __call__(self, item):
        """Blocking convenience: submit and wait."""
        return self.submit(item).result()

    def close(self, timeout: float = 5.0) -> None:
        with self._submit_lock:
            self._closed = True
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout)
        # fail anything that raced past the closed check so no caller
        # blocks forever on an orphaned Future
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("batcher is closed"))

    # ------------------------------------------------------------ worker

    def _collect(self):
        """Block for the first item, then drain for up to flush_ms."""
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        t_end = time.monotonic() + self._flush_s
        while len(batch) < self._max_batch:
            remaining = t_end - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            if self._closed and not batch:
                return
            items = [it for it, _ in batch]
            futures = [f for _, f in batch]
            try:
                results = self._batch_fn(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results "
                        f"for {len(items)} items"
                    )
                for fut, res in zip(futures, results):
                    fut.set_result(res)
            except Exception as ex:  # noqa: BLE001 - the batch's callers get it
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(ex)
            if self._closed and self._queue.empty():
                return
