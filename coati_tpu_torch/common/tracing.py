"""Spans and counters inside the port, on the profiler's clock.

The process has one tracer, stopped until `start()`:

    from coati_tpu_torch.common import tracing

    tracing.start()
    smiles = model.smiles_to_2d_batch(tokens, tokenizer)
    tracing.stop()
    snap = tracing.snapshot()
    snap["spans"]["decode.step"]          # {"count": 33, "seconds": 0.61}
    snap["counters"]["decode.live_row_steps"]
    snap["records"][0]                    # {"name", "start_ns", "end_ns", "id", "parent", "request"}

`span(name)` is a context manager around a piece of work, `count(name, n)`
adds to a counter. While the tracer is stopped a span checks two flags and
does nothing else: no clock read, no record, no device work; `count` checks
one. While it is started, each span adds its seconds to per-name totals
and, unless opened with `record=False`, keeps a record in a bounded buffer
(`RECORD_LIMIT`; records past it are counted in `dropped`): its name, start
and end in nanoseconds since the Unix epoch (`time.time_ns()`, the clock of
`torch.profiler`'s events), its id, its parent's id, and a request id that
every span under one outermost span shares. Spans nest through a stack per
thread.

Whenever a torch profiler is active, started tracer or not, a span also
opens a host range "coati.<name>" in it, so the spans show in any profile
(`training.diagnostics.profile_trace`'s among them) on the device trace's
own clock, above the kernels they launched. The range is an operator's
(`torch._C._profiler._RecordFunctionFast`), not a user annotation
(`torch.profiler.record_function`), which costs the host several times
more under the profiler: spans a string (`tokenize`) would then inflate
the very shares the profile is read for.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

import torch

RECORD_LIMIT = 100_000
PREFIX = "coati."

_on = False  # the tracer is started
_lock = threading.Lock()
_local = threading.local()  # .stack: this thread's open recorded spans
_ids = itertools.count(1)
_totals = defaultdict(lambda: [0, 0])  # name -> [count, nanoseconds]
_counters = defaultdict(int)
_records = []  # (name, start_ns, end_ns, id, parent, request)
_dropped = 0
_profiling = torch.autograd._profiler_enabled  # is a torch profiler active


def start() -> None:
    """Start keeping totals, records and counters (they add to what an
    earlier start kept; `reset()` clears them)."""
    global _on
    _on = True


def stop() -> None:
    global _on
    _on = False


def started() -> bool:
    return _on


def reset() -> None:
    """Clear the totals, records, counters and the dropped count."""
    global _dropped
    with _lock:
        _totals.clear()
        _counters.clear()
        _records.clear()
        _dropped = 0


def snapshot() -> dict:
    """What the tracer kept, as plain data: `spans` {name: {"count",
    "seconds"}}, `counters` {name: n}, `records` (dicts, in the order the
    spans ended), `dropped` (records past the buffer) and `started`."""
    with _lock:
        return {
            "spans": {k: {"count": c, "seconds": ns / 1e9} for k, (c, ns) in _totals.items()},
            "counters": dict(_counters),
            "records": [dict(zip(("name", "start_ns", "end_ns", "id", "parent", "request"), r))
                        for r in _records],
            "dropped": _dropped,
            "started": _on,
        }


def count(name: str, n=1) -> None:
    """Add n to the counter `name` while the tracer is started."""
    if _on:
        with _lock:
            _counters[name] += int(n)


_IDLE = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "record", "range", "start", "id", "parent", "request")

    def __init__(self, name: str, record: bool):
        self.name, self.record = name, record
        self.range = self.start = None

    def __enter__(self):
        if _profiling():
            self.range = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
            self.range.__enter__()
        if _on:
            if self.record:
                stack = getattr(_local, "stack", None)
                if stack is None:
                    stack = _local.stack = []
                self.id = next(_ids)
                self.parent = stack[-1].id if stack else None
                self.request = stack[-1].request if stack else self.id
                stack.append(self)
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.start is not None:
            end = time.time_ns()
            with _lock:
                total = _totals[self.name]
                total[0] += 1
                total[1] += end - self.start
                if self.record:
                    if len(_records) < RECORD_LIMIT:
                        _records.append((self.name, self.start, end, self.id, self.parent,
                                         self.request))
                    else:
                        _dropped += 1
            if self.record:
                _local.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, record: bool = True):
    """A context manager around one piece of work named `name` (totals
    only, no record, with `record=False`: for spans too many to keep one
    by one)."""
    if not _on and not _profiling():
        return _IDLE
    return _Span(name, record)
