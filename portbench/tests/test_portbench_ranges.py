"""The readers of the program's spans (portbench/ranges.py and the metrics
that read it) on synthetic traces: what each reads, None where the
program left no span (a program without the spans), and the profile's
other numbers unmoved by the spans' host ranges."""

import pytest
from small import ROOT  # noqa: F401 (puts the checkout on the path)

from portbench import ranges
from portbench.harness import Trace, metric_reader

RT_METRICS = ("tokenize.host_share.infer", "decode.stop_wait_share", "decode.launches_per_step",
              "decode.idle_share")
TRAIN_METRICS = ("train.xform_share", "train.batch_wait_share", "train.device_wait_share")


def _round_trip():
    """One request: two strings tokenized, the API call with its encode,
    prefill and a decode of two steps (each ending in the stop read), the
    copy to the host and the detokenization. Seconds from 0."""
    spans = [
        ("coati.tokenize", 0.00, 0.01), ("coati.tokenize", 0.01, 0.03),
        ("coati.api.smiles_to_2d_batch", 0.10, 1.00),
        ("coati.encode", 0.10, 0.20), ("coati.prefill", 0.20, 0.30),
        ("coati.decode", 0.30, 0.88), ("coati.decode.stop_read", 0.30, 0.32),
        ("coati.decode.step", 0.32, 0.60), ("coati.decode.sample", 0.32, 0.40),
        ("coati.decode.forward", 0.40, 0.50), ("coati.decode.stop_read", 0.50, 0.60),
        ("coati.decode.step", 0.60, 0.88), ("coati.decode.sample", 0.60, 0.70),
        ("coati.decode.forward", 0.70, 0.80), ("coati.decode.stop_read", 0.80, 0.88),
        ("coati.to_host", 0.88, 0.90), ("coati.detokenize", 0.90, 1.00),
    ]
    aten = [("aten::mm", 0.11, 0.12), ("aten::all", 0.301, 0.305), ("aten::sort", 0.33, 0.34), ("aten::copy_", 0.52, 0.53),
            ("aten::sort", 0.61, 0.62), ("aten::copy_", 0.81, 0.82), ("aten::copy_", 0.885, 0.89)]
    device = [
        ("encode_kernel", 0.12, 0.18), ("prefill_kernel", 0.21, 0.31),
        ("sort_kernel", 0.34, 0.36), ("decode_kernel", 0.45, 0.55),
        ("Memcpy DtoH (Device -> Pageable)", 0.55, 0.56),
        ("sort_kernel", 0.62, 0.64), ("decode_kernel", 0.75, 0.80),
        ("elementwise_kernel", 0.80, 0.81), ("Memcpy DtoH (Device -> Pageable)", 0.81, 0.82),
        ("Memcpy DtoH (Device -> Pageable)", 0.886, 0.887),
    ]
    return device, aten, spans


def _train():
    """Three profiled steps: the profile opened inside the first step's wait
    for its batch (so that wait is not in it) and closed inside the fourth's
    (cut at the stop, no batch copied after it)."""
    spans = [("coati.train.xform", 0.00, 0.08), ("coati.train.to_device", 0.09, 0.10),
             ("coati.train.step", 0.10, 0.30), ("coati.train.device_wait", 0.10, 0.14),
             ("coati.train.forward_backward", 0.14, 0.30)]
    for k in (1, 2):
        t = 0.3 * k
        spans += [("coati.train.batch", t, t + 0.12), ("coati.train.xform", t + 0.01, t + 0.11),
                  ("coati.train.to_device", t + 0.12, t + 0.13),
                  ("coati.train.step", t + 0.13, t + 0.30),
                  ("coati.train.device_wait", t + 0.13, t + 0.19),
                  ("coati.train.forward_backward", t + 0.19, t + 0.30)]
    spans.append(("coati.train.batch", 0.90, 0.901))  # open when the profile stopped
    device = [("k4", 0.15, 0.35), ("k3", 0.45, 0.62), ("k4", 0.75, 0.92)]
    return device, [("aten::mm", 0.15, 0.16)], spans


def _record(device, host, **extra):
    return dict(trace=Trace(device, host), log={}, **extra)


def test_round_trip_readers_read_the_program_spans():
    device, aten, spans = _round_trip()
    r = _record(device, aten + spans, traced_wall_s=0.5, traced_decode_steps=2)
    assert metric_reader("tokenize.host_share.infer")(r) == pytest.approx(100 * 0.03 / 0.5)
    # stop reads: 0.02 + 0.10 + 0.08 of the decode's 0.58
    assert metric_reader("decode.stop_wait_share")(r) == pytest.approx(100 * 0.20 / 0.58)
    # inside the steps: sort, decode (step 1); sort, decode, elementwise (step 2);
    # the copies are no launches, the prefill kernel started before
    assert metric_reader("decode.launches_per_step")(r) == pytest.approx(2.5)
    assert r["log"]["decode_step_spans"] == 2
    # the card busy in the decode 0.30-0.31, 0.34-0.36, 0.45-0.56, 0.62-0.64, 0.75-0.82
    busy = 0.01 + 0.02 + 0.11 + 0.02 + 0.07
    assert metric_reader("decode.idle_share")(r) == pytest.approx(100 * (0.58 - busy) / 0.58)


def test_idle_by_span_names_each_gap_by_the_innermost_open_span():
    device, aten, spans = _round_trip()
    r = _record(device, aten + spans, traced_wall_s=0.5)
    ranges.log_idle_by_span(r)
    idle = r["log"]["idle_by_span"]
    # gaps 0.18-0.21 (encode), 0.31-0.34, 0.56-0.62, 0.82-0.886 (stop reads),
    # 0.36-0.45, 0.64-0.75 (sampling), largest first
    assert list(idle) == ["decode.sample", "decode.stop_read", "encode"]
    assert idle == pytest.approx({"decode.sample": 0.20, "decode.stop_read": 0.156,
                                  "encode": 0.03})


def test_train_readers_take_the_waits_the_profile_saw_whole():
    device, aten, spans = _train()
    r = _record(device, aten + spans, traced_wall_s=0.9, traced_steps=3)
    step = 0.9 / 3
    assert ranges.fetches(r["trace"]) == [pytest.approx((0.3, 0.42)), pytest.approx((0.6, 0.72))]
    assert metric_reader("train.batch_wait_share")(r) == pytest.approx(100 * 0.12 / step)
    # the transforms inside those waits; the first step's (its wait unseen) left out
    assert metric_reader("train.xform_share")(r) == pytest.approx(100 * 0.10 / step)
    waits = (0.04 + 0.06 + 0.06) / 3
    assert metric_reader("train.device_wait_share")(r) == pytest.approx(100 * waits / step)
    assert "idle_by_span" in r["log"]


@pytest.mark.parametrize("metric", RT_METRICS + TRAIN_METRICS)
def test_every_reader_reads_none_without_the_program_spans(metric):
    device, aten, _ = _round_trip()
    read = metric_reader(metric)
    assert read(_record(device, aten, traced_wall_s=0.5, traced_steps=3)) is None
    assert read({"window_s": 1.0}) is None


def test_the_spans_host_ranges_leave_busy_time_launches_and_breakdown_as_they_were():
    """The ranges are host operations: the card's busy time and launches
    are its own, and a gap that begins after the first operator inside a
    span keeps the operator's name in the breakdown."""
    device, aten, spans = _round_trip()
    bare, spanned = Trace(device, aten), Trace(device, aten + spans)
    assert spanned.busy_s == bare.busy_s
    assert spanned.launches == bare.launches == 7
    assert spanned.breakdown() == bare.breakdown()
