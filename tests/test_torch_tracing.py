"""The port's tracer (coati_tpu_torch/common/tracing.py) and its spans and
counters in the round trip and the trainer, on the CPU: a stopped tracer
costs no clock, record or device work; a started one keeps one root per
public call, the decode loop's steps and live rows as the returned tokens
show them, and the trainer's steps; spans lie on their profiler ranges."""

import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from coati_tpu_torch.common import tracing
from coati_tpu_torch.data.batch_pipe import batch_rows
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import transformer
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training import config as tconfig
from coati_tpu_torch.training import train as ttrain
from coati_tpu_torch.training.diagnostics import profile_trace
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN(CC)CC", "C1CCCCC1O", "OC(=O)c1ccccc1"]


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.stop()
    tracing.reset()
    yield
    tracing.stop()
    tracing.reset()


class _Ops(TorchDispatchMode):
    """Every torch operation run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


class _NoClock:
    def __getattr__(self, name):
        raise AssertionError(f"the stopped tracer read time.{name}")


def _small_model(seed=0):
    tok = TrieTokenizer(n_seq=32, **get_vocab("mar_verysimple"))
    cfg = tco.CoatiConfig(n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=32,
                          n_hidden_e3nn=16, n_embd_common=32, n_head=2, n_seq=32,
                          n_tok=tok.n_token, norm_clips=True, token_mlp=True)
    torch.manual_seed(seed)
    model = tco.CoatiModel(cfg).requires_grad_(False)
    return COATI(model, cfg, seed=seed), tok


class _KeepRows:
    """The tokenizer, keeping the token rows a call detokenizes."""

    def __init__(self, tok):
        self._tok, self.rows = tok, []

    def decode_batch(self, rows, *args, **kwargs):
        self.rows.append(np.asarray(rows))
        return self._tok.decode_batch(rows, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._tok, name)


def _rows(tok):
    return np.asarray([tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in SMILES])


def test_stopped_tracer_reads_no_clock_keeps_nothing_and_runs_no_operation(monkeypatch):
    model, tok = _small_model()
    rows = _rows(tok)
    monkeypatch.setattr(tracing, "time", _NoClock())
    assert not torch.autograd._profiler_enabled()
    with _Ops() as seen:
        with tracing.span("outer"):
            with tracing.span("inner", record=False):
                tracing.count("things", 3)
    assert seen.ops == []
    model.smiles_to_2d_batch(rows, tok, k=5, inv_temp=1.0)
    snap = tracing.snapshot()
    assert snap == {"spans": {}, "counters": {}, "records": [], "dropped": 0,
                    "started": False}


def test_round_trip_keeps_one_root_per_call_its_steps_and_live_rows(monkeypatch):
    model, tok = _small_model(seed=3)
    rows = _rows(tok)
    forwards = []
    real_step = transformer.decode_step  # what the sampler calls for this trunk (models/trunks.py)

    def counted_step(*args, **kwargs):
        forwards.append(1)
        return real_step(*args, **kwargs)

    monkeypatch.setattr(transformer, "decode_step", counted_step)
    kept = _KeepRows(tok)
    prefix = len(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    tracing.start()
    steps = []
    for _ in range(2):
        before = len(forwards)
        model.smiles_to_2d_batch(rows, kept, k=5, inv_temp=1.0)
        steps.append(len(forwards) - before)
    tracing.stop()
    snap = tracing.snapshot()
    records = snap["records"]
    by_id = {r["id"]: r for r in records}
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["api.smiles_to_2d_batch"] * 2
    assert len({r["request"] for r in roots}) == 2
    for r in records:  # each record within its parent, in its root's request
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] is not None:
            parent = by_id[r["parent"]]
            assert parent["start_ns"] <= r["start_ns"] and r["end_ns"] <= parent["end_ns"]
            assert r["request"] == parent["request"]
    for root, n in zip(roots, steps):
        mine = [r for r in records if r["request"] == root["request"]]
        names = [r["name"] for r in mine]
        assert names.count("decode.step") == n > 0
        assert names.count("decode.forward") == names.count("decode.sample") == n
        assert names.count("decode.stop_read") == n + 1  # and one before the first step
        for name in ("encode", "prefill", "decode", "to_host", "detokenize"):
            assert names.count(name) == 1, name
        step_ids = {r["id"] for r in mine if r["name"] == "decode.step"}
        assert all(r["parent"] in step_ids for r in mine
                   if r["name"] in ("decode.sample", "decode.forward"))
    # live row-steps counted from the returned tokens: each row's steps
    # before the one that wrote its [STOP]
    live = 0
    for served in kept.rows:
        for row in served:
            live += int(np.argmax(row == tok.stop_token)) - prefix
    counters = snap["counters"]
    assert set(counters) == {"decode.row_steps", "decode.live_row_steps"}
    assert counters["decode.live_row_steps"] == live
    assert snap["spans"]["decode.step"]["count"] == sum(steps) == len(forwards)
    assert counters["decode.row_steps"] == len(SMILES) * sum(steps)
    assert live < counters["decode.row_steps"]
    assert "tokenize" not in {r["name"] for r in records}  # totals only
    assert snap["spans"]["tokenize"]["count"] == 2  # the prefixes, one a call


def test_decode_graph_counters_read_zero_on_the_cpu_path():
    """decode.graph_captures and decode.graph_steps count the decode
    graph's captures and replays (models/decode_graph.py), which run on the
    card alone: a round trip on the CPU decodes eagerly, so both read zero
    (absent) while its steps are counted, and no capture span opens."""
    model, tok = _small_model(seed=4)
    tracing.start()
    model.smiles_to_2d_batch(_rows(tok), tok, k=5, inv_temp=1.0)
    tracing.stop()
    snap = tracing.snapshot()
    counters = snap["counters"]
    assert counters.get("decode.graph_captures", 0) == 0
    assert counters.get("decode.graph_steps", 0) == 0
    assert counters["decode.row_steps"] == len(SMILES) * snap["spans"]["decode.step"]["count"] > 0
    assert "decode.capture" not in snap["spans"]


def test_nested_public_calls_share_one_request_and_count_rows_once():
    model, tok = _small_model()
    atoms = np.array([[6, 6, 8, 0], [7, 6, 0, 0]])
    coords = np.random.default_rng(0).normal(size=(2, 4, 3)).astype(np.float32)
    tracing.start()
    model.points_to_2d_batch(atoms, coords, tok, k=1)
    tracing.stop()
    snap = tracing.snapshot()
    records = snap["records"]
    roots = [r for r in records if r["parent"] is None]
    assert [r["name"] for r in roots] == ["api.points_to_2d_batch"]
    assert {r["request"] for r in records} == {roots[0]["id"]}
    assert {"api.encode_points", "api.vectors_to_2d_batch"} <= {r["name"] for r in records}
    # the nested call's decode counts its two rows once
    assert snap["counters"]["decode.row_steps"] == 2 * snap["spans"]["decode.step"]["count"] > 0


def test_span_starts_and_ends_with_its_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("warm_up"):
            pass
        tracing.start()
        with tracing.span("sleep"):
            time.sleep(0.01)
        tracing.stop()
    (rec,) = [r for r in tracing.snapshot()["records"] if r["name"] == "sleep"]
    (ev,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "coati.sleep"]
    assert abs(ev.start_ns() - rec["start_ns"]) < 500_000
    assert abs(ev.start_ns() + ev.duration_ns() - rec["end_ns"]) < 500_000
    assert rec["end_ns"] - rec["start_ns"] >= 10_000_000
    assert "warm_up" not in tracing.snapshot()["spans"]  # ranged, but the tracer was stopped


def test_profile_trace_carries_the_coati_ranges(tmp_path):
    with profile_trace(str(tmp_path)):
        with tracing.span("traced_block"):
            torch.ones(4).sum()
    (path,) = Path(tmp_path).glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "coati.traced_block" in names


class _Molecules:
    """A small dataset of the trainer: SMILES with random atoms and
    coordinates, through the port's batch_rows."""

    summary = {"dataset_type": "tracing-test"}

    def get_data_pipe(self, batch_size=2, partition="train", required_fields=(),
                      xform_routine=lambda x: x, **kw):
        rng = np.random.default_rng(0)
        frags = ["C", "CC", "CCO", "CCN", "CCC"]

        def rows():
            for i in range(batch_size * 6):
                smi = frags[i % len(frags)]
                yield {"smiles": smi, "source_collection": "geom_drugs",
                       "atoms": rng.integers(1, 9, size=(len(smi),)).astype(np.float64),
                       "coords": rng.normal(size=(len(smi), 3))}

        return batch_rows(rows(), batch_size=batch_size, partition="raw",
                          xform_routine=xform_routine, required_fields=["smiles"])


def test_four_train_steps_trace_four_steps_and_the_transform_inside_the_batch_wait(tmp_path):
    config = tconfig.TrainConfig(
        n_layer_e3gnn=1, n_hidden_e3nn=16, n_hidden_xformer=16, n_embd_common=16,
        n_layer_xformer=1, n_head=2, n_seq=24, max_n_seq=24, tokenizer_vocab="mar_verysimple",
        batch_size=2, n_epochs=1, lr=1e-3, norm_clips=True, token_mlp=True,
        output_dir=str(tmp_path / "out"), model_dir=str(tmp_path / "models"),
        p_dataset=0.0, p_formula=0.0, p_fim=0.0, p_graph=0.0, p_clip=0.5, p_randsmiles=0.0,
        log_batch_loss=1, ngrad_to_save=1e9,
    )
    tracing.start()
    _, results = ttrain.train_autoencoder(config, _Molecules(), device="cpu",
                                          max_steps_per_epoch=4)
    tracing.stop()
    snap = tracing.snapshot()
    spans, counters = snap["spans"], snap["counters"]
    assert len(results["history"]) == 4
    assert spans["train.step"]["count"] == spans["train.forward_backward"]["count"] == 4
    # the fifth batch is fetched, transformed and copied before the loop stops
    assert spans["train.batch"]["count"] == spans["train.xform"]["count"] == 5
    assert spans["train.to_device"]["count"] == 5
    assert spans["train.device_wait"]["count"] == 4  # three in the loop, one at the end
    assert 0 < spans["train.xform"]["seconds"] <= spans["train.batch"]["seconds"]
    assert counters == {}  # the trainer keeps spans only; its steps are train.step's count
    batches = {r["id"] for r in snap["records"] if r["name"] == "train.batch"}
    assert all(r["parent"] in batches for r in snap["records"] if r["name"] == "train.xform")


def test_the_record_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "RECORD_LIMIT", 3)
    tracing.start()
    for _ in range(5):
        with tracing.span("s"):
            pass
    snap = tracing.snapshot()
    assert len(snap["records"]) == 3 and snap["dropped"] == 2
    assert snap["spans"]["s"]["count"] == 5
    tracing.reset()
    assert tracing.snapshot()["dropped"] == 0


def test_threads_keep_their_own_stacks_and_lose_no_update():
    threads, spans = 12, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.start()

        def work():
            for _ in range(spans):
                with tracing.span("outer"):
                    with tracing.span("inner"):
                        tracing.count("n")

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
        tracing.stop()
    snap = tracing.snapshot()
    assert snap["counters"]["n"] == threads * spans
    assert snap["spans"]["inner"]["count"] == snap["spans"]["outer"]["count"] == threads * spans
    by_id = {r["id"]: r for r in snap["records"]}
    for r in snap["records"]:
        if r["name"] == "inner":
            assert by_id[r["parent"]]["name"] == "outer"
            assert r["request"] == r["parent"]
        else:
            assert r["parent"] is None and r["request"] == r["id"]
