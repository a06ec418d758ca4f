"""CUDA graphs in the port: the one mechanism behind the decode graph
(models/decode_graph.py) and the training step's (training/step_graph.py).

A replay runs what its capture launched over the memory it read, so a
client keys its graphs by shape and keeps their inputs as static buffers.
Shared here: the `eager()` switch; the `LRU` of a client's graphs and of
the keys it met (a key is captured on its second use, so a shape met once
costs no capture); the `layout` check; the side stream, capture and
replay. A launch made during a capture is counted in the capture's record
(`build.recording_launches`) and `replay` adds it, so the kernels'
counters count what runs on the card. Warm-ups, spans and counters are
each client's own.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import torch

from coati_tpu_torch.ops.kernels import build

_lock = threading.Lock()
_eager_holds = 0  # open `eager()` blocks
_local = threading.local()  # .streams: this thread's side stream a device


@contextlib.contextmanager
def eager():
    """Every decode call and training step that starts inside the block, in
    any thread, runs eagerly; blocks nest. For callers that swap the kernel
    wrappers a step calls (a replay bypasses them) and for comparisons."""
    global _eager_holds
    with _lock:
        _eager_holds += 1
    try:
        yield
    finally:
        with _lock:
            _eager_holds -= 1


def allowed() -> bool:
    """Whether a graph may run: no `eager()` block is open."""
    return not _eager_holds


class LRU:
    """At most `most` values by key, the least recently used going first:
    a client's graphs (`get`, `keep`), and the keys it met (`met_before`)."""

    def __init__(self, most: int):
        self.most = most
        self.items: OrderedDict = OrderedDict()

    def get(self, key):
        """The value of `key`, now the most recently used; None if none."""
        value = self.items.get(key)
        if value is not None:
            self.items.move_to_end(key)
        return value

    def keep(self, key, value) -> None:
        """Keep `value` for `key`; a caller holding a graph let go keeps it."""
        self.items[key] = value
        self.items.move_to_end(key)
        while len(self.items) > self.most:
            self.items.popitem(last=False)

    def met_before(self, key) -> bool:
        """Note a use of `key`; whether one is remembered from before."""
        met = self.get(key) is not None
        self.keep(key, True)
        return met


def layout(tensors) -> list:
    """Where a graph reads each tensor: the object, its address, shape,
    stride, dtype and device. A replay reads the captured addresses with
    the captured strides and dtype, so a tensor that moved (`param.data =
    ...`, a module taken off the card and back) needs a new capture, and
    one changed in place does not. The object is compared because the
    training graph hands its gradient buffers to the Parameter objects it
    was captured over; a decode module keeps its tensor objects from call
    to call, so there it changes nothing."""
    return [(id(t), t.data_ptr(), t.shape, t.stride(), t.dtype, t.device) for t in tensors]


@contextlib.contextmanager
def side_stream(device):
    """Run the block (a client's warm-up, then its capture, which may not
    run on the default stream) on this thread's side stream of `device`,
    behind the current stream's work, which then waits for the block's."""
    device = torch.device(device)
    streams = _local.__dict__.setdefault("streams", {})
    with torch.cuda.device(device):
        if device not in streams:
            streams[device] = torch.cuda.Stream(device)
        side, current = streams[device], torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield
        current.wait_stream(side)


def capture(fn, pool=None, generator=None) -> tuple:
    """A CUDA graph of `fn()` captured on the current stream, in `pool` if
    given: (graph, what `fn` returned, the launches recorded). A replay
    draws from a registered `generator` as the eager call would."""
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    # torch.cuda.graph's capture without the gc.collect() and empty_cache()
    # it runs first: a capture happens inside a caller's decode call or
    # training step, where both cost time, and the capture needs neither
    with build.recording_launches() as launches:
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out, launches


def replay(graph, launches: dict) -> None:
    """Replay `graph` and count the launches its capture recorded."""
    graph.replay()
    build.add_launches(launches)
