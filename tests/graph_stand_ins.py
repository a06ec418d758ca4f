"""Stand-ins for the parts of coati_tpu_torch.ops.graphs that need a card,
so the CPU tests drive the decode graph and the training graph through
their own code: `side_stream` runs its block as it is, `capture` runs the
function once (where a capture on the card runs nothing) and returns a
`StandInGraph`, whose replay runs it again and writes what it returns into
what the capture returned, and torch.cuda.Event does nothing."""

import contextlib

import torch

from coati_tpu_torch.ops import graphs


def _tensors(out):
    return out if isinstance(out, (tuple, list)) else (out,)


class StandInGraph:
    def __init__(self, owner, fn, out):
        self.owner, self.fn, self.out, self.replays = owner, fn, out, 0

    def replay(self):
        self.replays += 1
        self.owner.phase = "replay"
        try:
            for mine, new in zip(_tensors(self.out), _tensors(self.fn())):
                mine.copy_(new)
        finally:
            self.owner.phase = "eager"


class _Event:
    def record(self):
        pass

    def synchronize(self):
        pass


class StandIns:
    """The stand-ins installed by `install`: `made` lists the graphs
    captured, `phase` says whether code runs eagerly, in a capture or in a
    replay."""

    def __init__(self):
        self.made, self.phase = [], "eager"

    def capture(self, fn, pool=None, generator=None):
        self.phase = "capture"
        try:
            out = fn()
        finally:
            self.phase = "eager"
        graph = StandInGraph(self, fn, out)
        self.made.append(graph)
        return graph, out, {}

    def release(self):
        """Let go of the captured functions, which a CUDA graph does not
        hold (they hold the weights a graph reads)."""
        for graph in self.made:
            graph.fn = None


def install(monkeypatch) -> StandIns:
    stand_ins = StandIns()
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "capture", stand_ins.capture)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return stand_ins
