"""The single-device training step's forward and backward captured as one
CUDA graph per batch shape and replayed each step (training/train.py's
`TrainStep`).

Launched eagerly, a grande training step is some 4,800 kernels, and the
card waits on the host that launches them: it is busy about 40 ms of a
0.30 s step. The forward and the backward do the same work at every step
of one batch shape: the weights stay where they are (AdamW updates them in
place), and only the batch and the generator's draws change. A
`TrainGraph` owns the five model inputs as static tensors, and a graph of
`TrainStep.losses` and `loss.backward()` over them; a step is then five
copies of the batch into those tensors and one replay. The gradient clip
and the fused AdamW stay eager, called through `optimizer.step()` as on
the eager path: they are a few dozen multi-tensor launches, and the
optimizer's global hooks, the restart and checkpoint code and the
learning-rate schedule then see the optimizer as they always have.

When it engages (`engages`): the model on a CUDA device, no placement (one
device, no collectives), a training step, no `pick_point` given, and no
`eager()` block open. Everywhere else the eager step runs, unchanged: CPU
tensors, mesh runs and the dry run, evaluation steps, a given clip-token
choice; COATI2's step is its own class and never comes here. A caller that
swaps or instruments the kernel wrappers the step calls opens `eager()` (a
graph replays what its capture called).

Shapes: a graph is keyed by the five inputs' shapes and dtypes and their
device. A key is captured on its second use by a step: its first step runs
eagerly and is only noted (the last `SEEN_SHAPES` keys are kept), so a
batch width met once costs no capture. The second step of a key is the
capture: it runs eagerly on the capture's side stream, which loads there
what a capture needs (the kernels, cuBLAS's workspace) and is that step's
own result, and then captures the forward and backward, which runs
nothing. Every later step of the key replays. A step keeps at most
`MAX_SHAPES` graphs, the least recently used going first; a key let go is
captured again at its next use. A graph is captured again too when the
model's parameters no longer sit where it read them (another tensor,
address, shape, stride or dtype: `param.data = ...`, or the model moved),
or the step is given another generator; parameters changed in place
(AdamW, `load_state_dict`) are read as they are. The capture runs over
new leaf tensors that share the parameters' memory (`fresh_leaves`), so a
caller that keeps an earlier step's autograd graph alive (a loss not
detached) cannot tie the capture to the stream that step ran on; while it
runs, another thread sees those leaves in the model.

Memory and lifetime: the graphs of a step share one memory pool, so the
activations of the graph set are held once; each graph keeps its own
gradient buffers there, and its static inputs and loss scalars. They live
with the `TrainStep` that captured them. After a replay each parameter's
`.grad` is that graph's buffer of it, so the optimizer reads that replay's
gradients; setting the gradients to None afterwards, as the eager path
does, only lets go of a reference the graph still holds. A parameter the
loss does not reach (the EGNN's coordinate MLPs) has no buffer, and the
optimizer gives it a zero gradient as on the eager path.

Randomness: the step's generator (the clip-token draws of
`models/coati._pick_point`) is registered with each graph, so a replay
draws from the same stream at the same offsets as the eager step would and
advances it as far; a capture advances it not at all. The checkpointed
transformer blocks keep no RNG state (they draw no random numbers).

Counters: the kernel wrappers count the launches a capture records apart
from their counters (`ops/kernels/build.recording_launches`; K4 and K5b
launch from autograd's thread, on the capture's stream), and a replay adds
exactly those, so `.launches` and `.bwd_launches` count what runs on the
card. Those of `common.tracing`: `train.graph_captures` (one a capture)
and `train.graph_steps` (one a replay); spans `train.capture` and
`train.graph_replay`.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Dict, Optional

import torch
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.ops.kernels import build

INPUTS = ("raw_tokens", "tokens", "y_next", "atoms", "coords")
MAX_SHAPES = 8  # graphs kept a step
SEEN_SHAPES = 64  # keys remembered for the second-use rule

_lock = threading.Lock()
_eager_holds = 0  # open `eager()` blocks


@contextlib.contextmanager
def eager():
    """Every training step that starts inside the block, in any thread,
    runs eagerly: for callers that swap or instrument the kernel wrappers
    the step calls, which a graph would bypass at replay, and for
    comparisons with the eager path."""
    global _eager_holds
    with _lock:
        _eager_holds += 1
    try:
        yield
    finally:
        with _lock:
            _eager_holds -= 1


def engages(step, pick_point=None) -> bool:
    """Whether `step` (a TrainStep) may run its forward and backward
    through a graph (see the module's docstring)."""
    if not step.is_training or pick_point is not None or step.parallel.placement is not None:
        return False
    if _eager_holds:
        return False
    first = next(step.model.parameters(), None)
    return first is not None and first.device.type == "cuda"


def key_of(batch: Dict[str, torch.Tensor]) -> tuple:
    """The graph key of a batch: each input's shape and dtype, and the
    device."""
    return tuple((tuple(batch[k].shape), batch[k].dtype) for k in INPUTS) + (
        str(batch[INPUTS[0]].device),)


def forward_backward(step, generator, batch, pick_point=None) -> tuple:
    """The eager forward and backward: (loss, ar_loss, clip_loss), the
    gradients on the parameters."""
    loss, ar, cl = step.losses(generator, batch, pick_point)
    loss.backward()
    return loss, ar, cl


@contextlib.contextmanager
def fresh_leaves(model: nn.Module, params: list):
    """Inside the block each parameter of `model` is replaced by a new leaf
    tensor over the same memory (one for a parameter two modules share);
    yields those leaves in the order of `params`. A capture's backward then
    leaves its gradients on them, through gradient accumulators made on the
    capture's stream: a parameter's own accumulator may be older, kept
    alive by an autograd graph a caller still holds (a loss not detached),
    and tied to the stream that graph ran on, which a capture may not make
    wait."""
    fresh, swapped = {}, []
    for module in model.modules():
        for name, p in module._parameters.items():
            if p is not None:
                if id(p) not in fresh:
                    fresh[id(p)] = nn.Parameter(p.detach(), requires_grad=p.requires_grad)
                swapped.append((module, name, p))
    for module, name, p in swapped:
        module._parameters[name] = fresh[id(p)]
    try:
        yield [fresh[id(p)] for p in params]
    finally:
        for module, name, p in swapped:
            module._parameters[name] = p


def _layout(params: list) -> list:
    """Where a graph reads each parameter: the tensor, its address, shape,
    stride and dtype."""
    return [(id(p), p.data_ptr(), p.shape, p.stride(), p.dtype) for p in params]


class ShapeCache:
    """The bookkeeping of a step's graphs: which keys were met, which hold
    a graph. A key is captured on its second use (`met_before`; the last
    `seen` keys are remembered), and at most `most` graphs are kept, the
    least recently used going first."""

    def __init__(self, most: int = MAX_SHAPES, seen: int = SEEN_SHAPES):
        self.most, self.seen_most = most, seen
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()

    def get(self, key):
        """The graph kept for `key`, now the most recently used; None if
        none is."""
        graph = self.graphs.get(key)
        if graph is not None:
            self.graphs.move_to_end(key)
        return graph

    def met_before(self, key) -> bool:
        """Note a use of `key`; whether it was met before."""
        if key in self.seen:
            self.seen.move_to_end(key)
            return True
        self.seen[key] = None
        while len(self.seen) > self.seen_most:
            self.seen.popitem(last=False)
        return False

    def keep(self, key, graph) -> None:
        """Keep `graph` for `key`, letting go of the least recently used
        past `most`."""
        self.graphs[key] = graph
        self.graphs.move_to_end(key)
        while len(self.graphs) > self.most:
            self.graphs.popitem(last=False)


class TrainGraph:
    """A step's forward and backward over static inputs, captured at
    construction on `side` into `pool` after the same step run eagerly
    there (see the module's docstring); `first` holds that eager run's
    (loss, ar_loss, clip_loss). `replay(batch)` runs the graph on a batch
    and returns its three losses, scalars the next replay overwrites."""

    def __init__(self, step, generator: Optional[torch.Generator], batch, pool, side):
        self.params = list(step.model.parameters())
        self.layout = _layout(self.params)
        self.generator = generator
        self.inputs = {k: batch[k].clone() for k in INPUTS}
        self.graph = torch.cuda.CUDAGraph()
        device = batch[INPUTS[0]].device
        with torch.cuda.device(device):
            current = torch.cuda.current_stream(device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                self.first = tuple(x.detach() for x in forward_backward(step, generator,
                                                                        self.inputs))
                if generator is not None:
                    self.graph.register_generator_state(generator)
                # torch.cuda.graph's capture without the gc.collect() and
                # empty_cache() it runs first; the kernels' launches in it are
                # recorded for the replays to count
                with fresh_leaves(step.model, self.params) as leaves, \
                        build.recording_launches() as self.launches:
                    self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                    try:
                        losses = forward_backward(step, generator, self.inputs)
                    finally:
                        self.graph.capture_end()
                self.losses = tuple(x.detach() for x in losses)
                self.grads = [leaf.grad for leaf in leaves]
            current.wait_stream(side)

    def current(self, step, generator) -> bool:
        """Whether the graph still reads the step's parameters where they
        are, and draws from `generator`."""
        return generator is self.generator and _layout(list(step.model.parameters())) == self.layout

    def replay(self, batch) -> tuple:
        for k in INPUTS:
            self.inputs[k].copy_(batch[k])
        self.graph.replay()
        build.add_launches(self.launches)
        for p, g in zip(self.params, self.grads):
            p.grad = g
        return self.losses


class StepGraphs:
    """The graphs of one TrainStep: their cache, memory pool and the side
    stream each device captures on."""

    def __init__(self, most: int = MAX_SHAPES, seen: int = SEEN_SHAPES):
        self.cache = ShapeCache(most, seen)
        self.pools, self.streams = {}, {}

    def run(self, step, generator, batch) -> tuple:
        """The step's forward and backward on `batch`: a replay of its
        key's graph, its capture, or (a key's first use) the eager step.
        Returns (loss, ar_loss, clip_loss)."""
        key = key_of(batch)
        graph = self.cache.get(key)
        if graph is not None and graph.current(step, generator):
            with tracing.span("train.graph_replay"):
                losses = graph.replay(batch)
            tracing.count("train.graph_steps")
            return losses
        if graph is None and not self.cache.met_before(key):
            return forward_backward(step, generator, batch)
        device = batch[INPUTS[0]].device
        if device not in self.pools:
            with torch.cuda.device(device):
                self.pools[device] = torch.cuda.graph_pool_handle()
                self.streams[device] = torch.cuda.Stream(device)
        with tracing.span("train.capture"):
            graph = TrainGraph(step, generator, batch, self.pools[device], self.streams[device])
        tracing.count("train.graph_captures")
        self.cache.keep(key, graph)
        return graph.first
