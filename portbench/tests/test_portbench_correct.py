"""`correct` decided on small sizes on the CPU: a sound run passes each
cell's limits, the control (the reference one precision below the
configuration) fails one of them, and so does the run with the timed path
broken underneath, once for each fault the cell can have."""

import numpy as np
import pytest
import torch

from small import context, run

from portbench import checks, faults, harness
from portbench.run import compare

INFERENCE = ["coati.roundtrip.smiles", "coati2.roundtrip.smiles", "coati.embed.smiles"]
CELLS = INFERENCE + ["coati.train.grande"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = run(context(cell))
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks" and line["attempted"] >= 1 and line["failed"] == 0


# the trained document's logits and embeddings are at their own scale: the
# COATI cells' controls run at the cell's own widths, on a few rows
FULL = {"coati.roundtrip.smiles", "coati.embed.smiles"}


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    ctx = context(cell, full=cell in FULL)
    drv = harness.driver(ctx.workload["driver"])
    state = drv.setup(ctx)
    drv.window(ctx, state)
    drv.release(ctx, state)
    compared = compare(ctx, drv.readings(ctx, state, checks.control_precision(ctx.cfg)))
    assert any(v > limit for _, v, limit in compared), compared


def _altered_sampler(monkeypatch):
    from coati_tpu_torch.models import sampler

    real = sampler.sample_top_k

    def altered(generator, logits, k, inv_temp, top_p=None):
        tok = real(generator, logits, k, inv_temp, top_p=top_p)
        tok[0] = logits[0].float().argmin()  # row 0 takes its least likely token
        return tok

    monkeypatch.setattr(sampler, "sample_top_k", altered)


@pytest.mark.parametrize("cell", ["coati.roundtrip.smiles", "coati2.roundtrip.smiles"])
def test_a_token_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    _altered_sampler(monkeypatch)
    ctx = context(cell)
    ctx.traffic["check_rows"] = 64  # every row of the small requests, row 0 among them
    assert not run(ctx)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.SAMPLER))
def test_a_broken_top_k_sampler_is_not_correct(fault):
    # the trained document's peaked distributions, as the cell serves them
    ctx = context("coati.roundtrip.smiles", full=True)
    ctx.traffic["check_rows_sampled"] = 64  # every row of the small top-k requests
    with faults.SAMPLER[fault]():
        line = run(ctx)
    assert not line["correct"], line["checks"]
    assert line["checks"]["sampled_gap_z"]["value"] > line["checks"]["sampled_gap_z"]["limit"]


def test_an_embedding_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from coati_tpu_torch.models import coati

    real = coati.encode_tokens

    def altered(*args, **kwargs):
        h = real(*args, **kwargs)
        return torch.cat([-h[:1], h[1:]])

    monkeypatch.setattr(coati, "encode_tokens", altered)
    ctx = context("coati.embed.smiles")
    ctx.traffic["check_rows"] = 10_000  # every row, row 0 of each request among them
    assert not run(ctx)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    from coati_tpu_torch.training import train

    def unchanged(self, closure=None):
        self.clip_gradients()

    monkeypatch.setattr(train.ClippedAdamW, "step", unchanged)
    assert not run(context("coati.train.grande"))["correct"]


def test_a_window_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    # sound through the warm-up steps the start's check follows, broken after
    from coati_tpu_torch.training import train

    # the step itself, not the wrapper that fires the optimizer's hooks,
    # which an earlier optimizer may have put on the class
    step = train.ClippedAdamW.step
    real, calls = getattr(step, "__wrapped__", step), []
    ctx = context("coati.train.grande")

    def late(self, closure=None):
        calls.append(1)
        if len(calls) > ctx.traffic["warmup_steps"]:
            return self.clip_gradients()
        return real(self, closure)

    monkeypatch.setattr(train.ClippedAdamW, "step", late)
    line = run(ctx)
    assert not line["correct"]
    assert all(c["value"] <= c["limit"] for k, c in line["checks"].items()
               if not k.startswith("window_")), line["checks"]


def test_next_token_labels_altered_where_they_are_made_are_not_correct(monkeypatch):
    # both sides train on the program's batches: only the transform's own
    # check can see its labels shifted
    from coati_tpu_torch.training import train

    real = train.clip_ar_xform

    def shifted(batch, **kwargs):
        out = real(batch, **kwargs)
        out["y_next"] = np.roll(out["y_next"], 1, axis=1)
        return out

    monkeypatch.setattr(train, "clip_ar_xform", shifted)
    line = run(context("coati.train.grande"))
    assert line["checks"]["transform_rows_wrong"]["value"] > 0 and not line["correct"]


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from coati_tpu_torch.training import train

    real = train.TrainStep.losses

    def half(self, generator, batch, pick_point=None):
        n = batch["tokens"].shape[0] // 2
        return real(self, generator, {k: v[:n] for k, v in batch.items()}, pick_point)

    monkeypatch.setattr(train.TrainStep, "losses", half)
    assert not run(context("coati.train.grande"))["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(cell):
    line = run(context(cell, trace=True))
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    for metric in line["metrics"].values():  # host-side readings; device ones need the card
        assert metric["value"] >= 0
