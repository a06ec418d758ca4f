"""The decode step's forward captured once as a CUDA graph and replayed for
every token of `generate_tokens` (models/sampler.py), through ops/graphs.py.

A `StepGraph` holds the token (B,), the position (one int32 on the card),
the KV cache at the call's width and the float32 logits as static
buffers, and a graph of the trunk's `decode_step_at` over them that ends
by advancing the position. Sampling stays in the sampler, so a generator
makes the same draws as on the eager path; the early-exit read depends on
the sampling alone, so it is copied to pinned memory before the replay and
read after it. `stepper` hands the sampler a `StepGraph` or an `EagerStep`
behind one interface; a graph engages (`eligible`) for tensors on a CUDA
device and weights already in the compute dtype (`cast_floats` returned
the caller's module, so the same tensors from call to call).

A graph is keyed by (transformer config, B, width, device). The memory of
the last `SEEN_SHAPES` keys is one for all weights modules; a module keeps
at most `MAX_SHAPES` graphs (weakly), each with its cache: 2.6 GB for
COATI grande's int8 cache at B 1024 and width 250. Before a thread's first
capture of a key it runs one eager step on its side stream, which K1
counts, and throws it away: the capture comes before the call's prefill
fills the graph's cache, so there is no real step to run yet. One call
uses a graph at a time; another call of the key meanwhile runs eagerly.
Spans and counters: `decode.capture`, `decode.graph_captures` (one a
capture), `decode.graph_steps` (one a replay).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import weakref
import torch
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import trunks
from coati_tpu_torch.ops import graphs

MAX_SHAPES = 4  # graphs kept a weights module
SEEN_SHAPES = 64  # keys remembered for the second-use rule

_lock = threading.Lock()
_kept: "weakref.WeakKeyDictionary[nn.Module, graphs.LRU]" = weakref.WeakKeyDictionary()
_seen = graphs.LRU(SEEN_SHAPES)
_local = threading.local()  # .warmed: keys this thread has warmed up


def _weights(params: nn.Module) -> list:
    """Every tensor the module tree holds: parameters and buffers, and the
    plain tensor attributes of a `cast_floats` copy."""
    out = []
    for m in params.modules():
        out.extend(t for t in m._parameters.values() if t is not None)
        out.extend(t for t in m._buffers.values() if t is not None)
        out.extend(t for t in vars(m).values() if isinstance(t, torch.Tensor))
    return out


def eligible(params: nn.Module, compute: nn.Module, device: torch.device) -> bool:
    """Whether a decode over `compute` (`cast_floats(params, ...)`) on
    `device` may run through a graph (see the module's docstring)."""
    return torch.device(device).type == "cuda" and compute is params and graphs.allowed()


class EagerStep:
    """`decode_step` at a host position, over a cache made when the prefill
    asks for it (inside its span); the stop read waits for the step."""

    def __init__(self, compute: nn.Module, cfg, batch: int, width: int, device):
        self.compute, self.cfg, self.trunk = compute, cfg, trunks.of(cfg)
        self.new_cache = functools.partial(self.trunk.make_empty_cache, cfg, batch, width=width,
                                           device=device)

    @functools.cached_property
    def cache(self):
        return self.new_cache()

    def start(self, pos: int) -> None:
        self.pos = pos

    def post_stopped(self, stopped: torch.Tensor) -> None:
        self.stopped = stopped

    def read_stopped(self) -> bool:
        return bool(self.stopped.all())

    def step(self, token: torch.Tensor) -> torch.Tensor:
        logits, _ = self.trunk.decode_step(self.compute, self.cfg, token, self.pos, self.cache)
        self.pos += 1
        return logits.float()


class StepGraph:
    """The graphed stepper: one decode step over static buffers, captured at
    construction; `step(token)` returns logits the next step overwrites."""

    def __init__(self, params: nn.Module, cfg, batch: int, width: int, device):
        device = torch.device(device)
        self.cache = trunks.of(cfg).make_empty_cache(cfg, batch, width=width, device=device)
        self.token = torch.zeros(batch, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.int32, device=device)
        self.tables = trunks.of(cfg).decode_tables(cfg, device)
        self.layout = graphs.layout(_weights(params))
        self.lock = threading.Lock()
        self.all_stopped = torch.zeros((), dtype=torch.bool, pin_memory=device.type == "cuda")
        self.posted = torch.cuda.Event()
        warmed = _local.__dict__.setdefault("warmed", set())
        key = (cfg, batch, width, str(device))
        with graphs.side_stream(device):
            if key not in warmed:
                self._forward(params, cfg)
                warmed.add(key)
            self.graph, self.logits, self.launches = graphs.capture(
                lambda: self._forward(params, cfg))
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
        """Whether `params`' tensors still sit where the graph reads them."""
        return graphs.layout(_weights(params)) == self.layout

    def start(self, pos: int) -> None:
        self.pos.fill_(pos)

    def post_stopped(self, stopped: torch.Tensor) -> None:
        """Start copying whether every row has stopped to pinned memory,
        behind the sampling and before the replay."""
        self.all_stopped.copy_(stopped.all(), non_blocking=True)
        self.posted.record()

    def read_stopped(self) -> bool:
        """What `post_stopped` copied, once copied; the replay runs on."""
        self.posted.synchronize()
        return bool(self.all_stopped)

    def step(self, token: torch.Tensor) -> torch.Tensor:
        self.token.copy_(token)
        graphs.replay(self.graph, self.launches)
        tracing.count("decode.graph_steps")
        return self.logits


def _acquire(params, cfg, batch: int, width: int, device) -> StepGraph | None:
    """The key's graph, locked for this call (captured if none reads the
    current weights); None at the key's first use, or while another holds it."""
    key = (cfg, batch, width, str(device))
    with _lock:
        kept = _kept.setdefault(params, graphs.LRU(MAX_SHAPES))
        graph = kept.get(key)
        if graph is None:
            if not _seen.met_before(key):
                return None
        elif not graph.lock.acquire(blocking=False):
            return None
    if graph is not None:
        if graph.current(params):
            return graph
        graph.lock.release()
    with tracing.span("decode.capture"):
        graph = StepGraph(params, cfg, batch, width, device)
    tracing.count("decode.graph_captures")
    graph.lock.acquire()
    with _lock:
        kept.keep(key, graph)
    return graph


@contextlib.contextmanager
def stepper(params: nn.Module, compute: nn.Module, cfg, batch: int, first: int, width: int,
            device):
    """The stepper of a decode from position `first` over a cache of `width`,
    held for the block: a StepGraph where one runs, else an EagerStep."""
    graph = _acquire(compute, cfg, batch, width, device) if width > first and eligible(
        params, compute, device) else None
    if graph is None:
        yield EagerStep(compute, cfg, batch, width, device)
        return
    try:
        yield graph
    finally:
        graph.lock.release()


def kept_graphs(params: nn.Module) -> list:
    """The StepGraphs `params` keeps, the least recently used first."""
    with _lock:
        return list(_kept[params].items.values()) if params in _kept else []


def kept_shapes(params: nn.Module) -> int:
    """How many graphs `params` keeps."""
    return len(kept_graphs(params))
