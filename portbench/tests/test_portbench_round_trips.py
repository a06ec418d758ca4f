"""The cells of the point-cloud round trip and of the DeepSeek-V2-Lite trunk
at small sizes on the CPU: a sound run is correct, the control (the
reference one precision below) and each planted fault are not, and a
traced run reads its per-layer metrics."""

import pytest

from small import context, run

from portbench import checks, faults, harness
from portbench.run import compare

CELLS = ["dsv2lite.roundtrip.smiles", "coati.roundtrip.points"]
# DeepSeek-V2-Lite's block at widths a test holds (the published shape: a
# dense layer, then expert layers; top 6 of 16 routed, 4 held, 2 shared)
MLA_TINY = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 32,
            "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
            "intermediate_size": 96, "moe_intermediate_size": 24, "n_routed_experts": 4,
            "router_width": 16, "first_expert": 2, "num_hidden_layers": 3, "n_seq": 48,
            "n_embd_common": 32, "n_hidden_e3nn": 16, "n_layer_e3gnn": 1}


# the trained document's logits are at their own scale: the point cell's
# control and faults run at the cell's own widths, on a few rows
FULL = {"coati.roundtrip.points"}


def small(cell, full=False, **kw):
    ctx = context(cell, full=full, **kw)
    if ctx.workload["config"] == "coati_dsv2lite":
        ctx.cfg.update(MLA_TINY)
    return ctx


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    line = run(small(cell))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 2 and line["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    ctx = small(cell, full=cell in FULL)
    drv = harness.driver(ctx.workload["driver"])
    state = drv.setup(ctx)
    drv.window(ctx, state)
    drv.release(ctx, state)
    compared = compare(ctx, drv.readings(ctx, state, checks.control_precision(ctx.cfg)))
    assert any(v > limit for _, v, limit in compared), compared


@pytest.mark.parametrize("fault", sorted(faults.SAMPLER))
def test_a_broken_top_k_sampler_is_not_correct(fault):
    # the trained document's peaked distributions; the seeded trunk's are
    # flat at every width, and its sampler faults show only over the cell's
    # own tokens (calibrate_round_trips.py on the card)
    ctx = small("coati.roundtrip.points", full=True)
    ctx.traffic["check_rows_sampled"] = 64  # every row of the small top-k requests
    with faults.SAMPLER[fault]():
        line = run(ctx)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_token_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from coati_tpu_torch.models import sampler

    real = sampler.sample_top_k

    def altered(generator, logits, k, inv_temp, top_p=None):
        tok = real(generator, logits, k, inv_temp, top_p=top_p)
        tok[0] = logits[0].float().argmin()  # row 0 takes its least likely token
        return tok

    monkeypatch.setattr(sampler, "sample_top_k", altered)
    ctx = small(cell)
    ctx.traffic["check_rows"] = 64  # every row of the small requests, row 0 among them
    assert not run(ctx)["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(cell):
    line = run(small(cell, trace=True))
    assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
    for metric in line["metrics"].values():
        assert metric["value"] >= 0
    if cell.startswith("dsv2lite"):  # the program's counters, read on the CPU too
        assert line["metrics"]["moe.load_imbalance"]["value"] >= 1.0
