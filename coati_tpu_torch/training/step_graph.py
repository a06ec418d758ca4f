"""The single-device training step's forward and backward captured as one
CUDA graph per batch shape and replayed each step (training/train.py's
`TrainStep`), through ops/graphs.py.

A `TrainGraph` holds the five model inputs as static tensors and a graph
of `TrainStep.losses` and `loss.backward()` over them. The gradient clip
and the fused AdamW stay eager, a few dozen multi-tensor launches, so the
optimizer's hooks, checkpoints and schedule see it as they always have.
`StepGraphs.run` is the forward and backward either way; a graph engages
(`engages`) for a training step on one CUDA device, with no placement and
no `pick_point` given.

A graph is keyed by the five inputs' shapes and dtypes and their device; a
step has its own memory of the last `SEEN_SHAPES` keys and keeps at most
`MAX_SHAPES` graphs, in one memory pool a device. A key's second step runs
eagerly on the side stream, where it loads what a capture needs, and is
that step's own result; then the forward and backward are captured, over
fresh leaves, with the step's generator registered (the checkpointed
blocks draw no random numbers). A graph is captured again when the
parameters moved or the generator is another. After a replay each
parameter's `.grad` is that graph's buffer of it; one the loss does not
reach (the EGNN's coordinate MLPs) has none, and the optimizer gives it a
zero gradient as on the eager path. Spans and counters: `train.capture`,
`train.graph_replay`, `train.graph_captures`, `train.graph_steps`.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
from torch import nn

from coati_tpu_torch.common import tracing
from coati_tpu_torch.ops import graphs

INPUTS = ("raw_tokens", "tokens", "y_next", "atoms", "coords")
MAX_SHAPES = 8  # graphs kept a step
SEEN_SHAPES = 64  # keys remembered for the second-use rule


def engages(step, pick_point=None) -> bool:
    """Whether `step` (a TrainStep) may run its forward and backward
    through a graph (see the module's docstring)."""
    if not step.is_training or pick_point is not None or step.parallel.placement is not None \
            or not graphs.allowed():
        return False
    first = next(step.model.parameters(), None)
    return first is not None and first.device.type == "cuda"


def key_of(batch: Dict[str, torch.Tensor]) -> tuple:
    """A batch's graph key: each input's shape and dtype, and the device."""
    return tuple((tuple(batch[k].shape), batch[k].dtype) for k in INPUTS) + (
        str(batch[INPUTS[0]].device),)


def forward_backward(step, generator, batch, pick_point=None) -> tuple:
    """The eager forward and backward: (loss, ar_loss, clip_loss)."""
    loss, ar, cl = step.losses(generator, batch, pick_point)
    loss.backward()
    return loss, ar, cl


@contextlib.contextmanager
def fresh_leaves(model: nn.Module, params: list):
    """Inside the block each parameter of `model` is a new leaf over the
    same memory (one for a parameter two modules share); yields those of
    `params`. A capture's backward leaves its gradients there, through
    accumulators made on its stream: a parameter's own may be kept alive by
    an autograd graph a caller holds (a loss not detached), tied to the
    stream that graph ran on, which a capture may not make wait."""
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


class TrainGraph:
    """A step's forward and backward over static inputs, captured into
    `pool` after the same step run eagerly, whose (loss, ar_loss,
    clip_loss) are `first`; `replay(batch)` returns scalars it overwrites."""

    def __init__(self, step, generator: Optional[torch.Generator], batch, pool):
        self.params = list(step.model.parameters())
        self.layout = graphs.layout(self.params)
        self.generator = generator
        self.inputs = {k: batch[k].clone() for k in INPUTS}
        with graphs.side_stream(batch[INPUTS[0]].device):
            self.first = tuple(x.detach() for x in forward_backward(step, generator, self.inputs))
            with fresh_leaves(step.model, self.params) as leaves:
                self.graph, losses, self.launches = graphs.capture(
                    lambda: forward_backward(step, generator, self.inputs), pool, generator)
            self.losses = tuple(x.detach() for x in losses)
            self.grads = [leaf.grad for leaf in leaves]

    def current(self, step, generator) -> bool:
        """Whether it reads the parameters where they are, from `generator`."""
        return generator is self.generator and graphs.layout(
            step.model.parameters()) == self.layout

    def replay(self, batch) -> tuple:
        for k in INPUTS:
            self.inputs[k].copy_(batch[k])
        graphs.replay(self.graph, self.launches)
        for p, g in zip(self.params, self.grads):
            p.grad = g
        return self.losses


class StepGraphs:
    """The graphs of one TrainStep: the keys it met, the graphs it keeps
    and their memory pool a device."""

    def __init__(self):
        self.seen, self.kept = graphs.LRU(SEEN_SHAPES), graphs.LRU(MAX_SHAPES)
        self.pools = {}

    def run(self, step, generator, batch, pick_point) -> tuple:
        """(loss, ar_loss, clip_loss) of the step's forward and backward on
        `batch`: a replay of its key's graph, its capture, or eager."""
        if not engages(step, pick_point):
            return forward_backward(step, generator, batch, pick_point)
        key = key_of(batch)
        graph = self.kept.get(key)
        if graph is not None and graph.current(step, generator):
            with tracing.span("train.graph_replay"):
                losses = graph.replay(batch)
            tracing.count("train.graph_steps")
            return losses
        if graph is None and not self.seen.met_before(key):
            return forward_backward(step, generator, batch)
        device = batch[INPUTS[0]].device
        if device not in self.pools:
            with torch.cuda.device(device):
                self.pools[device] = torch.cuda.graph_pool_handle()
        with tracing.span("train.capture"):
            graph = TrainGraph(step, generator, batch, self.pools[device])
        tracing.count("train.graph_captures")
        self.kept.keep(key, graph)
        return graph.first
