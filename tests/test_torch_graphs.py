"""ops/graphs.py, the CUDA-graph mechanism that the decode graph and the
training graph share, on the CPU: the one `eager()` switch across
threads, the LRU behind the second-use rule and the kept graphs against a
plain reference, whose memory each client's second-use rule reads, the
layout check, and generate_tokens through the graphed stepper, with the
card-bound pieces stood in for (tests/graph_stand_ins.py), against the
eager path."""

import contextlib
import random
import threading
from types import SimpleNamespace

import pytest
import torch

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import decode_graph, mla_moe, sampler
from coati_tpu_torch.models import transformer as ttr
from coati_tpu_torch.ops import graphs
from coati_tpu_torch.training import step_graph
from coati_tpu_torch.training.train import ParallelStep
from tests import graph_stand_ins

STOP = 2


def _model(seed=0, trunk="compute"):
    """A seeded 2-layer trunk: COATI's with a KV cache of the compute dtype
    or int8, or DeepSeek-V2's latent attention and experts ("mla")."""
    if trunk == "mla":
        cfg = mla_moe.MlaMoeConfig(
            n_layer=2, n_embd=64, n_head=4, n_seq=48, n_tok=40, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, dense_width=96,
            expert_width=24, n_routed=16, top_k=6, n_shared=2, first_expert=4, n_held=8)
        make = mla_moe.MlaMoeTransformer
    else:
        cfg = ttr.TransformerConfig(n_layer=2, n_embd=64, n_head=4, n_seq=48, n_tok=40,
                                    kv_dtype=trunk)
        make = ttr.SmilesTransformer
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = make(cfg)
    return model.requires_grad_(False), cfg


def test_one_eager_block_in_one_thread_keeps_both_graphs_off_in_another():
    """A `graphs.eager()` block opened in one thread makes both
    decode_graph.eligible and step_graph.engages false in another, for as
    long as any of its nested blocks is open."""
    cuda = torch.device("cuda", 0)
    model = torch.nn.Linear(2, 2)
    on_card = SimpleNamespace(is_training=True, parallel=ParallelStep(), model=SimpleNamespace(
        parameters=lambda: iter([SimpleNamespace(device=cuda)])))

    def both():
        return decode_graph.eligible(model, model, cuda), step_graph.engages(on_card)

    stages = [threading.Event() for _ in range(4)]

    def hold():
        with graphs.eager():
            with graphs.eager():
                stages[0].set()
                stages[1].wait(30)
            stages[2].set()
            stages[3].wait(30)

    assert both() == (True, True)
    holder = threading.Thread(target=hold)
    holder.start()
    try:
        assert stages[0].wait(30)
        assert both() == (False, False)
        stages[1].set()
        assert stages[2].wait(30)
        assert both() == (False, False)  # the outer block is still open
    finally:
        stages[1].set()
        stages[3].set()
        holder.join(timeout=30)
    assert not holder.is_alive()
    assert both() == (True, True) and graphs.allowed()


@pytest.mark.parametrize("most,seen", [(1, 1), (2, 3), (3, 2), (4, 64), (8, 64)])
def test_second_use_memory_and_kept_graphs_follow_a_plain_reference(most, seen):
    """Keys drawn at random through the clients' rule (a kept graph is
    used; otherwise a key remembered from before is captured and kept, and
    one met for the first time only noted) give the same graphs, memory and
    order as lists kept by hand: the last `seen` keys remembered, at most
    `most` graphs kept, the least recently used going first."""
    rng = random.Random(most * 100 + seen)
    memory, kept = graphs.LRU(seen), graphs.LRU(most)
    ref_memory, ref_kept = [], []  # the least recently used first
    for _ in range(400):
        key = rng.randrange(10)
        graph = kept.get(key)
        if key in ref_kept:
            ref_kept.remove(key)
            ref_kept.append(key)
            assert graph == ("graph", key)
        else:
            assert graph is None
            met = memory.met_before(key)
            assert met == (key in ref_memory)
            if met:
                ref_memory.remove(key)
                kept.keep(key, ("graph", key))
                ref_kept = (ref_kept + [key])[-most:]
            ref_memory = (ref_memory + [key])[-seen:]
        assert list(memory.items) == ref_memory and list(kept.items) == ref_kept


def test_decode_shares_its_memory_of_shapes_across_modules_and_a_train_step_keeps_its_own(
        monkeypatch):
    """A shape met by one weights module is captured at another module's
    first call of it; a batch shape met by one TrainStep's graphs runs
    eagerly at another's first step of it, and is captured at its second."""
    stand_ins = graph_stand_ins.install(monkeypatch)
    monkeypatch.setattr(decode_graph, "_seen", graphs.LRU(decode_graph.SEEN_SHAPES))
    (model, cfg), (other, _) = _model(0), _model(1)
    assert decode_graph._acquire(model, cfg, 8, 16, "cpu") is None
    graph = decode_graph._acquire(other, cfg, 8, 16, "cpu")
    assert graph is not None and graph.graph is stand_ins.made[0]
    graph.lock.release()
    assert decode_graph.kept_shapes(other) == 1 and decode_graph.kept_shapes(model) == 0

    phases = []

    def forward_backward(step, generator, batch, pick_point=None):
        phases.append(stand_ins.phase)
        return torch.zeros(()), torch.zeros(()), torch.zeros(())

    monkeypatch.setattr(step_graph, "forward_backward", forward_backward)
    monkeypatch.setattr(step_graph, "engages", lambda step, pick_point=None: True)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    step = SimpleNamespace(model=torch.nn.Linear(2, 2))
    batch = {k: torch.zeros((4, 8), dtype=torch.long) for k in step_graph.INPUTS}
    first, second = step_graph.StepGraphs(), step_graph.StepGraphs()
    for _ in range(2):
        first.run(step, None, batch, None)
    assert phases == ["eager", "eager", "capture"]
    del phases[:]
    second.run(step, None, batch, None)
    assert phases == ["eager"] and len(stand_ins.made) == 2
    second.run(step, None, batch, None)
    assert phases == ["eager", "eager", "capture"] and len(stand_ins.made) == 3


def test_layout_follows_where_a_tensor_sits_not_its_values():
    """`graphs.layout` is unchanged by a write in place, and changed by new
    storage under the same Parameter, by a new Parameter over the same
    storage, and by another stride or dtype over the same memory."""
    lin = torch.nn.Linear(3, 3)
    before = graphs.layout(lin.parameters())
    with torch.no_grad():
        lin.weight.mul_(2.0)
    assert graphs.layout(lin.parameters()) == before
    lin.weight.data = lin.weight.data.clone()
    moved = graphs.layout(lin.parameters())
    assert moved != before
    lin.weight = torch.nn.Parameter(lin.weight.data)
    assert graphs.layout(lin.parameters()) != moved
    w = lin.weight.detach()
    assert graphs.layout([w.t()])[0][1:] != graphs.layout([w])[0][1:]
    assert graphs.layout([w.view(torch.int32)])[0][1:] != graphs.layout([w])[0][1:]


@pytest.mark.parametrize("trunk", ["compute", "int8", "mla"])
def test_generate_tokens_through_the_graphed_stepper_keeps_the_eager_tokens(trunk, monkeypatch):
    """With the capture stood in for by a replay that runs the captured
    step again, generate_tokens through decode_graph's StepGraph gives the
    eager path's tokens for the same generator seeds, sampled and with rows
    behind prefixes of different lengths, and stops after as many steps
    (row i draws [STOP] from its (2 i + 3)-th step on): the first call of
    the shape runs eagerly, the second captures, the third replays, and
    every replayed step is counted once."""
    stand_ins = graph_stand_ins.install(monkeypatch)
    monkeypatch.setattr(decode_graph, "_seen", graphs.LRU(decode_graph.SEEN_SHAPES))
    monkeypatch.setattr(decode_graph, "eligible",
                        lambda params, compute, device: compute is params and graphs.allowed())
    model, cfg = _model(5, trunk)
    tokens = torch.zeros(4, 24, dtype=torch.long)
    tokens[:, :5] = torch.randint(3, 33, (4, 5), generator=torch.Generator().manual_seed(6))
    lens = torch.tensor([3, 5, 3, 4])

    draw, drawn = sampler.sample_top_k, [0]

    def sample(generator, logits, k, inv_temp, top_p=None):
        drawn[0] += 1
        stop = torch.arange(len(logits)) < (drawn[0] - 1) // 2
        return torch.where(stop, STOP, draw(generator, logits, k, inv_temp, top_p=top_p))

    monkeypatch.setattr(sampler, "sample_top_k", sample)

    def generate(seed):
        drawn[0] = 0
        return sampler.generate_tokens(model, cfg, torch.Generator().manual_seed(seed), tokens,
                                       lens, prefill_len=3, total_len=24, stop_token=STOP, k=5,
                                       inv_temp=1.0)

    def traced(seed):
        tracing.reset()
        tracing.start()
        try:
            out = generate(seed)
        finally:
            tracing.stop()
        snap = tracing.snapshot()
        return out, snap["counters"], snap["spans"]["decode.step"]["count"]

    with graphs.eager():
        eager = [traced(seed) for seed in (11, 12, 13)]
    calls = [traced(seed) for seed in (11, 12, 13)]
    assert all(torch.equal(out, ref) for (out, _, _), (ref, _, _) in zip(calls, eager))
    assert [steps for _, _, steps in calls] == [steps for _, _, steps in eager]  # the early exit
    assert [c.get("decode.graph_captures", 0) for _, c, _ in calls] == [0, 1, 0]
    assert [c.get("decode.graph_steps", 0) for _, c, _ in calls] == [0, calls[1][2], calls[2][2]]
    assert len(stand_ins.made) == 1 and stand_ins.made[0].replays == calls[1][2] + calls[2][2]
    assert all(0 < steps < 24 - 3 for _, _, steps in calls)
