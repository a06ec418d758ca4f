"""The decode step's forward captured once as a CUDA graph and replayed for
every token of `generate_tokens` (models/sampler.py).

Launched eagerly, a decode step is some 845 small kernels, and the card
waits on the host that launches them. The step does the same work at
every position of a call: the shapes (B, cache width, layers), the
weights and the cache buffers stay; only the input token and the
position change. A `StepGraph` owns those two as static buffers (the
token (B,) int64, the position one int32 on the card), the KV cache at
the call's width and the step's float32 logits, and a graph of the
trunk's `decode_step_at` (models/trunks.py) over them: the K/V write and the rotary
row index by the device position (the rotary tables built once, at
capture), K1 reads it on the card, and the graph's last node advances it
by one. A step is then one copy of the sampled token and one replay; the
host never writes the position between steps. Sampling, the `stopped`
bookkeeping and the early-exit read stay eager in the sampler, so a
caller's generator makes the same draws as on the eager path. The
early-exit read depends on the sampling alone, so it is copied to pinned
host memory before the replay and read after it (`post_stopped`,
`read_stopped`): the host waits for the sampling, not for the step's
forward, and launches the next step's sampling while the card runs the
replay.

When it engages (`step_graph`): tensors on a CUDA device, and weights
already in the compute dtype (`cast_floats` returned the caller's module,
so the weight tensors are the same from call to call). Everywhere else,
CPU tensors and weights cast anew on every call among them, the eager
`decode_step` runs, unchanged; so does every call that starts inside an
`eager()` block, which a caller that swaps or instruments the step's
kernel wrappers opens (a graph replays what its capture called).

Shapes: a graph is keyed by (transformer config, B, width, device); the
config fixes the cache's dtype and its scales'. A key is captured on its
second use in the process, by any module: the first call of a shape
decodes eagerly and only notes it (the last `SEEN_SHAPES` are kept), so
a batch size met once, as a micro-batcher's odd flush may be, costs no
capture and no cache. A module keeps at most `MAX_SHAPES` graphs, the
least recently used going first. Each holds its cache, (L, 2, B, width,
H, Dh) int8 and its (L, 2, B, width, H) scales under an int8 cache: 2.6
GB for COATI grande at B 1024 and width 250, so a module holds at most
four such caches beside its weights. Measured on an H100: round trips
at B 1024, and calls cycling over six sizes from B 16 to 256, where
every call captures and still beats the eager step; a micro-batcher's
own traffic has not been.

Lifetime: the graphs are kept per weights module through a weak
reference, so they are freed with the model handle that holds the
module. A graph is captured again when the module's weight tensors no
longer sit where it read them (another address, shape, stride or dtype:
`param.data = ...`, or a module moved off the card and back); weights
changed in place are read as they are. A thread captures on one side
stream a device, and runs one eager warm-up step there before its first
capture of each key (it loads the kernels and cuBLAS's workspace for
that stream; a real step on the card, which K1's counter counts); a
later capture of the same key skips it. One call uses a graph at a time;
a second thread's call with the same key meanwhile runs eagerly.

Counters: K1's wrappers count the launches a capture records apart from
`.launches` (`ops/kernels/build.recording_launches`), and a replay adds
exactly those, so `.launches` counts what runs on the card. Those of
`common.tracing`: `decode.graph_captures` (one a capture) and
`decode.graph_steps` (replays, counted in the sampler).
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import trunks
from coati_tpu_torch.ops.kernels import build

MAX_SHAPES = 4  # graphs kept a weights module
SEEN_SHAPES = 64  # keys remembered for the second-use rule

_lock = threading.Lock()
_graphs: "weakref.WeakKeyDictionary[nn.Module, OrderedDict]" = weakref.WeakKeyDictionary()
_seen: OrderedDict = OrderedDict()  # keys met on the card, the newest last
_eager_holds = 0  # open `eager()` blocks
_local = threading.local()  # .streams: this thread's capture stream a device; .warmed: keys


def _thread_capture_state() -> tuple:
    """This thread's ({device: capture stream}, {keys warmed up on them})."""
    if not hasattr(_local, "streams"):
        _local.streams, _local.warmed = {}, set()
    return _local.streams, _local.warmed


def _weights(params: nn.Module) -> list:
    """Every tensor the module tree holds: parameters and buffers, and the
    plain tensor attributes of a `cast_floats` copy."""
    out = []
    for m in params.modules():
        out.extend(t for t in m._parameters.values() if t is not None)
        out.extend(t for t in m._buffers.values() if t is not None)
        out.extend(t for t in vars(m).values() if isinstance(t, torch.Tensor))
    return out


def _layout(params: nn.Module) -> list:
    """Where a graph reads each weight tensor: address, shape, stride,
    dtype and device."""
    return [(t.data_ptr(), t.shape, t.stride(), t.dtype, t.device) for t in _weights(params)]


@contextlib.contextmanager
def eager():
    """Every decode call that starts inside the block, in any thread, runs
    the eager step: for callers that swap or instrument the kernel wrappers
    the step calls, which a graph would bypass at replay (or keep past the
    block), and for comparisons with the eager path."""
    global _eager_holds
    with _lock:
        _eager_holds += 1
    try:
        yield
    finally:
        with _lock:
            _eager_holds -= 1


def eligible(params: nn.Module, compute: nn.Module, device: torch.device) -> bool:
    """Whether a decode over `compute` (`cast_floats(params, ...)`) on
    `device` may run through a graph: a CUDA device, weights already in the
    compute dtype, and no `eager()` block open."""
    return torch.device(device).type == "cuda" and compute is params and not _eager_holds


class StepGraph:
    """One decode step over static buffers, captured at construction (see
    the module's docstring). `start(pos)` sets the position of the first
    step; `step(token)` runs one and returns the (B, V) float32 logits,
    a buffer the next step overwrites."""

    def __init__(self, params: nn.Module, cfg, batch: int, width: int, device):
        device = torch.device(device)
        self.cache = trunks.of(cfg).make_empty_cache(cfg, batch, width=width, device=device)
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.int32, device=device)
        self.tables = trunks.of(cfg).decode_tables(cfg, device)
        self.layout = _layout(params)
        self.lock = threading.Lock()
        self.all_stopped = torch.zeros((), dtype=torch.bool, pin_memory=True)
        self.posted = torch.cuda.Event()
        self.graph = torch.cuda.CUDAGraph()
        streams, warmed = _thread_capture_state()
        key = (cfg, batch, width, str(device))
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side = streams.get(device)
            if side is None:
                side = streams[device] = torch.cuda.Stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                if key not in warmed:
                    # one eager step the first time this thread captures the
                    # shape: it loads the kernels and warms cuBLAS on `side`
                    self._forward(params, cfg)
                    warmed.add(key)
                # torch.cuda.graph's capture without the gc.collect() and
                # empty_cache() it runs first; K1's launches in it are
                # recorded for the replays to count
                with build.recording_launches() as self.launches:
                    self.graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        self.logits = self._forward(params, cfg)
                    finally:
                        self.graph.capture_end()
            current.wait_stream(side)
        self.bytes = sum(x.numel() * x.element_size() for x in (
            self.cache.data, self.cache.scale, self.token, self.pos, self.logits, *self.tables)
            if x is not None)

    def _forward(self, params, cfg) -> torch.Tensor:
        logits, _ = trunks.of(cfg).decode_step_at(params, cfg, self.token, self.pos, self.cache,
                                                  self.tables)
        out = logits.float()
        self.pos += 1
        return out

    def current(self, params: nn.Module) -> bool:
        """Whether `params`' weight tensors still sit where the graph reads
        them."""
        return _layout(params) == self.layout

    def start(self, pos: int) -> None:
        self.pos.fill_(pos)

    def post_stopped(self, stopped: torch.Tensor) -> None:
        """Start copying whether every row has stopped to pinned host
        memory, behind the sampling that updated `stopped`: called before
        the step's replay, so `read_stopped` need not wait for it."""
        self.all_stopped.copy_(stopped.all(), non_blocking=True)
        self.posted.record()

    def read_stopped(self) -> bool:
        """What `post_stopped` copied, once the copy is done; the replay
        after it runs on while the host launches the next step."""
        self.posted.synchronize()
        return bool(self.all_stopped)

    def step(self, token: torch.Tensor) -> torch.Tensor:
        self.token.copy_(token)
        self.graph.replay()
        build.add_launches(self.launches)
        return self.logits


def _kept(params: nn.Module) -> OrderedDict:
    kept = _graphs.get(params)
    if kept is None:
        kept = _graphs[params] = OrderedDict()
    return kept


def _acquire(params, cfg, batch: int, width: int, device) -> Optional[StepGraph]:
    """The graph of the key, locked for this call (captured if it has
    none, or none over the module's current weights); None when the key is
    met for the first time, or another call holds its graph."""
    key = (cfg, batch, width, str(device))
    with _lock:
        kept = _kept(params)
        graph = kept.get(key)
        if graph is not None:
            if not graph.lock.acquire(blocking=False):
                return None
            kept.move_to_end(key)
        elif key in _seen:
            _seen.move_to_end(key)
        else:
            _seen[key] = None
            while len(_seen) > SEEN_SHAPES:
                _seen.popitem(last=False)
            return None
    if graph is not None:
        if graph.current(params):
            return graph
        graph.lock.release()
        with _lock:
            if kept.get(key) is graph:
                del kept[key]
    with tracing.span("decode.capture"):
        graph = StepGraph(params, cfg, batch, width, device)
    tracing.count("decode.graph_captures")
    graph.lock.acquire()
    with _lock:
        kept[key] = graph
        while len(kept) > MAX_SHAPES:  # a call holding the one let go keeps it to its end
            kept.popitem(last=False)
    return graph


@contextlib.contextmanager
def step_graph(params: nn.Module, compute: nn.Module, cfg, batch: int, width: int, device):
    """The StepGraph a decode of `batch` rows over a cache of `width`
    positions runs through, held for the block; None where the eager step
    runs (see `eligible` and `_acquire`)."""
    graph = _acquire(compute, cfg, batch, width, device) if eligible(
        params, compute, device) else None
    try:
        yield graph
    finally:
        if graph is not None:
            graph.lock.release()


def kept_shapes(params: nn.Module) -> int:
    """How many graphs `params` keeps."""
    with _lock:
        kept = _graphs.get(params)
        return 0 if kept is None else len(kept)
