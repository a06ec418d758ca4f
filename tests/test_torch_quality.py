"""The port's decode-quality protocols (scripts/torch_eval_trained_decode.py,
scripts/torch_eval_coati2_conditioning.py) against the JAX package's
(scripts/eval_trained_decode.py, eval_int8_decode.py,
eval_coati2_conditioning.py) on the CPU: the measures on fixed strings and
token arrays, the per-configuration decodes of a seeded small document in
both packages at k 1 (sampled tokens are not comparable across packages:
jax.random and torch.Generator differ), the conditioning protocol at a few
steps, and the verdicts committed from the card."""

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from coati_tpu.models import coati as jco
from coati_tpu.models import sampler as jax_sampler
from coati_tpu.models.io import params_to_state, serialize_model

from coati_tpu_torch.examples import chembl_analysis
from coati_tpu_torch.models import api
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from coati_tpu_torch.models.transformer import forward_logits
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import eval_int8_decode  # noqa: E402
import eval_trained_decode  # noqa: E402
import torch_eval_coati2_conditioning as t_cond  # noqa: E402
import torch_eval_trained_decode as t_decode  # noqa: E402

sys.path.pop(0)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"
# fixed strings: valid, unbalanced rings, branches, brackets, a token the
# vocabulary lacks, the empty decode, and writings of one molecule
STRINGS = ["CCO", "c1ccccc1O", "C1CC", "CC(C", "CC)C", "C[NH3+]", "C[Xx]C", "", "OCC",
           "C1=CC=CC=C1O", "Oc1ccccc1", "CC(=O)Nc1ccc(O)cc1", "CC(=O)Nc1ccc(cc1)O", "N#N"]


@pytest.fixture(scope="module")
def mar():
    return TrieTokenizer(n_seq=64, **get_vocab("mar"))


def test_validity_proxy_and_same_molecule_equal_the_jax_script_s(mar):
    """On the fixed strings and on eval_int8_decode.py's own corpus."""
    strings = STRINGS + eval_int8_decode.make_corpus(24)
    for s in strings:
        assert chembl_analysis._valid_proxy(s, mar) == eval_trained_decode._valid_proxy(s, mar), s
    for a in strings:
        for b in strings:
            assert chembl_analysis._same_mol(a, b) == eval_trained_decode._same_mol(a, b), (a, b)
    assert chembl_analysis._same_mol("Oc1ccccc1", "c1ccccc1O")


def test_histogram_tv_and_token_agreement_equal_the_jax_scripts_expressions():
    """eval_trained_decode.py's histogram and total variation and
    eval_int8_decode.py's token agreement are inline expressions; these are
    they, verbatim, on fixed token arrays."""
    rng = np.random.default_rng(0)
    n_token = 40
    a, b = rng.integers(0, n_token, (2, 16, 30))
    b[:8] = a[:8]
    mine = t_decode.histogram_tv(t_decode.token_histogram(a, n_token),
                                 t_decode.token_histogram(b, n_token))
    hists = []
    for gen_region in (a, b):
        hist = np.bincount(gen_region.reshape(-1), minlength=n_token)
        hists.append(hist / max(hist.sum(), 1))
    assert mine == float(0.5 * np.abs(hists[1] - hists[0]).sum())
    assert t_decode.histogram_tv(hists[0], hists[0]) == 0.0
    toks, fp32_tokens = b, a
    assert t_decode.token_agreement(toks, fp32_tokens) == float(np.mean(toks == fp32_tokens))
    assert 0.5 <= t_decode.token_agreement(toks, fp32_tokens) < 1.0


def _small_document(path: Path, tok) -> str:
    """A seeded 2-layer x 64 COATI of the trained document's vocabulary,
    written as coati_tpu's document; the port's loader carries it across
    (models/convert.py)."""
    kw = dict(n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=64, n_hidden_e3nn=16,
              n_embd_common=64, n_head=4, n_seq=tok.n_seq, n_tok=tok.n_token,
              norm_clips=True, token_mlp=True)
    params = jco.init_coati(jax.random.PRNGKey(3), jco.CoatiConfig(**kw))
    path.write_bytes(serialize_model({"tokenizer_vocab": "mar"}, {}, params_to_state(params), kw))
    return str(path)


def _greedy(fn, calls):
    """fn with k forced to 1, its (rows, n_seq) outputs kept in `calls`."""
    def call(*args, **kwargs):
        kwargs["k"] = 1
        out = fn(*args, **kwargs)
        calls.append(np.asarray(out.cpu() if hasattr(out, "cpu") else out))
        return out
    return call


def test_evaluate_decodes_each_configuration_as_the_jax_script_does(tmp_path, mar, monkeypatch):
    """torch_eval_trained_decode.evaluate and eval_trained_decode.evaluate
    on one seeded small document and the same 16 molecules (8 of each
    split of the protocol), every decode at k 1. fp32: the round-trip and
    the sampled rows' tokens are equal, row for row. bf16+int8: the two
    packages round bf16 products and the int8 cache differently (XLA's CPU
    dot against PyTorch's), and this untrained model's logits lie within
    a few bf16 ulps of each other (about 2.0, an ulp 2^-6); so a row is
    equal, or at the first step where it differs the two tokens' logits,
    teacher-forced through the port's bf16 model on the row's tokens so
    far, are within 2 bf16 ulps of the step's largest logit (a rounding
    tie), and no row differs in its first 4 generated tokens."""
    doc = _small_document(tmp_path / "small.pkl", mar)
    train, hold = chembl_analysis.split_corpus(str(CORPUS))
    smiles = chembl_analysis.rt_subset(train, 8) + chembl_analysis.rt_subset(hold, 8)

    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax_sampler, "generate_tokens",
                        _greedy(jax_sampler.generate_tokens, jax_calls))
    monkeypatch.setattr(eval_trained_decode, "SAMPLE_B", 16)
    jax_verdict = eval_trained_decode.evaluate(doc, smiles, str(tmp_path / "jax.json"))
    monkeypatch.setattr(api, "generate_tokens", _greedy(api.generate_tokens, port_calls))
    mine = t_decode.evaluate(doc, CORPUS, rt_sample=8, sample_b=16, device="cpu")

    n_train, n_hold = mine["rt_rows"]["train"], mine["rt_rows"]["holdout"]
    assert n_train + n_hold == jax_verdict["eval_molecules"] >= 12
    # per configuration: the JAX script decodes its round trips in one call
    # and then its sample; the port each split, then its sample
    assert len(jax_calls) == 2 * 5 and len(port_calls) == 3 * 4
    jax_by = dict(zip(["fp32", "bf16", "bf16+int8", "default", "pallas"],
                      zip(jax_calls[::2], jax_calls[1::2])))
    port_by = {name: (np.concatenate(port_calls[3 * i : 3 * i + 2]), port_calls[3 * i + 2])
               for i, (name, _) in enumerate(t_decode.CONFIGS)}
    for got, want in zip(port_by["fp32"], jax_by["fp32"]):
        np.testing.assert_array_equal(got, want)
    p = len(mar.tokenize_text(t_decode.PREFIX, pad=False))
    base, tok = load_e3gnn_smiles_clip_e2e(doc, device="cpu")
    model = COATI(base.params, base.config.replace(**dict(t_decode.CONFIGS)["bf16+int8"]))
    h = torch.cat([base.encode_tokens(chembl_analysis.roundtrip_rows(tok, rows)[1], tok)
                   for rows in (smiles[:8], smiles[8:])])
    sample_h = h[np.random.default_rng(t_decode.SAMPLE_IDX_SEED).integers(0, len(h), size=16)]
    for got, want, rows_h in zip(port_by["bf16+int8"], jax_by["bf16+int8"], (h, sample_h)):
        assert got.shape == want.shape == (len(rows_h), tok.n_seq)
        for row, other, hi in zip(got, want, rows_h):
            differ = np.nonzero(row != other)[0]
            if not len(differ):
                continue
            d = int(differ[0])
            assert d >= p + 4
            with torch.no_grad():
                logits = forward_logits(
                    model._compute.xformer, model.config.xformer_config,
                    torch.as_tensor(row[None, :d]), model._clip_token(hi[None]),
                    tok.unk_token)[0, -1].float()
            ulp = 2.0 ** (np.floor(np.log2(float(logits.abs().max()))) - 7)
            assert abs(float(logits[row[d]] - logits[other[d]])) <= 2 * ulp, (d, row[d],
                                                                              other[d])
    # the measures of fp32, whose decodes are equal, are the JAX script's
    ref = jax_verdict["results"]["fp32+exact_topk"]
    got = mine["results"]["fp32"]
    rows = n_train + n_hold
    assert (got["greedy_roundtrip_train"] * n_train + got["greedy_roundtrip_holdout"] * n_hold
            == pytest.approx(ref["greedy_roundtrip"] * rows))
    for key in ("mean_len", "stop_rate", "validity_proxy"):
        assert got[key] == pytest.approx(ref[key]), key
    assert got["hist_tv_vs_fp32"] == 0.0 and got["token_agreement_vs_fp32"] == 1.0
    assert set(mine["verdict"]) == {"bf16", "bf16+int8", "default"}
    assert mine["results"]["default"]["kv"] == "int8/float32"
    assert mine["results"]["bf16"]["kv"] == "bfloat16"


def test_main_runs_both_parts_on_a_small_document(tmp_path, mar):
    """main at a few rows on the CPU: part 1's four configurations and part
    2's protocol in the production setting, whose bulk draws go through
    complete_batch on the bf16 compute copy (which used to raise there:
    generate_prefix_batch took the device from the copy's parameters, and
    a cast copy registers none)."""
    doc = _small_document(tmp_path / "small.pkl", mar)
    out_path = tmp_path / "decode.json"
    out = t_decode.main(["--doc", doc, "--device", "cpu", "--rt_sample", "4", "--sample_b", "4",
                         "--batches", "1", "--batch_size", "4", "--out", str(out_path)])
    saved = json.loads(out_path.read_text())
    assert saved.keys() == out.keys() >= {"card", "decode_configurations", "generation_quality",
                                          "ok"}
    assert set(saved["decode_configurations"]["results"]) == {"fp32", "bf16", "bf16+int8",
                                                              "default"}
    quality = saved["generation_quality"]
    assert quality["setting"] == {"dtype": "bfloat16"} and quality["n_samples"] == 4
    assert set(quality["numbers"]) == {"greedy_roundtrip_train", "greedy_roundtrip_holdout",
                                       "fraction_valid", "fraction_unique", "mean_len"}
    assert out["ok"] == (saved["decode_configurations"]["ok"] and quality["ok"])


def test_quality_vs_fp32_bands_valid_and_unique_only():
    def quality(rt, valid, unique):
        return {"greedy_roundtrip_train": rt, "greedy_roundtrip_holdout": rt / 2,
                "bulk": {"fraction_valid": valid, "fraction_unique": unique, "mean_len": 60.0,
                         "n_samples": 10_240}}

    fp32 = quality(0.5, 0.60, 0.61)
    record = json.loads(t_decode.RECORD.read_text())
    ok = t_decode.quality_vs_fp32(quality(0.3, 0.62, 0.59), fp32, record)
    assert ok["ok"] and ok["numbers"]["fraction_valid"]["diff"] == pytest.approx(0.02)
    assert "band" not in ok["numbers"]["greedy_roundtrip_train"]
    assert ok["numbers"]["fraction_valid"]["record"] == record["bulk"]["fraction_valid"]
    miss = t_decode.quality_vs_fp32(quality(0.5, 0.56, 0.61), fp32, record)
    assert not miss["ok"] and not miss["numbers"]["fraction_valid"]["ok"]


def test_conditioning_main_runs_a_few_steps(tmp_path, monkeypatch):
    """The conditioning protocol at EVAL_STEPS=5 on the CPU: its corpus is
    the JAX script's, it trains, generates for the four targets and writes
    the verdict's keys."""
    from eval_coati2_conditioning import make_corpus

    assert t_cond.make_corpus() == make_corpus()
    monkeypatch.setenv("EVAL_STEPS", "5")
    out_path = tmp_path / "cond.json"
    out = t_cond.main(["--device", "cpu", "--out", str(out_path)])
    saved = json.loads(out_path.read_text())
    assert saved.keys() == out.keys() >= {"card", "mean_length", "clean_chains", "monotone",
                                          "correlation", "ok", "final_loss", "steps",
                                          "seconds"}
    assert saved["steps"] == 5 and np.isfinite(saved["final_loss"])
    assert sorted(saved["mean_length"], key=int) == ["5", "8", "11", "14"]
    assert out["device"] == "cpu"


def test_conditioning_verdict_needs_a_monotone_rise_and_correlation():
    assert t_cond.verdict({5: 5.1, 8: 7.9, 11: 11.2, 14: 13.8})["ok"]
    assert not t_cond.verdict({5: 5.1, 8: 7.9, 11: 7.8, 14: 13.8})["ok"]
    assert not t_cond.verdict({5: 5.0, 8: float("nan"), 11: 11.0, 14: 14.0})["ok"]
    flat = t_cond.verdict({5: 9.0, 8: 9.01, 11: 9.02, 14: 12.0})
    assert flat["monotone"] and flat["correlation"] < 0.9 and not flat["ok"]


# the verdicts committed from the card


def _committed(name):
    with open(ROOT / "docs" / name) as f:
        return json.load(f)


def test_trained_decode_verdict_from_the_card_holds_the_jax_rule():
    """docs/torch_eval_trained_decode.json, written by
    scripts/torch_eval_trained_decode.py on the card: every configuration
    but fp32 within 0.02 of fp32's round trip on each split and TV <= 0.05;
    the production setting's fraction valid and unique within 0.03 of
    float32's."""
    v = _committed("torch_eval_trained_decode.json")
    assert v["ok"] is True and "H100" in v["card"] and "W" in v["card"]
    decode = v["decode_configurations"]
    assert decode["rt_rows"]["train"] >= 2000 and decode["sample_batch"] >= 1024
    results = decode["results"]
    assert set(results) == {"fp32", "bf16", "bf16+int8", "default"}
    ref = results["fp32"]
    for name, r in results.items():
        for split in ("train", "holdout"):
            assert r[f"greedy_roundtrip_{split}"] >= ref[f"greedy_roundtrip_{split}"] - 0.02
        assert r["hist_tv_vs_fp32"] <= 0.05
    quality = v["generation_quality"]
    assert quality["ok"] is True and quality["n_samples"] >= 10_000
    for key in ("fraction_valid", "fraction_unique"):
        row = quality["numbers"][key]
        assert abs(row["production"] - row["fp32"]) <= 0.03


def test_conditioning_verdict_from_the_card():
    """docs/torch_eval_coati2_conditioning.json, written by
    scripts/torch_eval_coati2_conditioning.py on the card after 3,000
    steps: the mean generated length rises with the conditioning target,
    correlation >= 0.9; training ran K5f and K5b, and generation K1 (its
    prefill takes K5f: the trainer's config sets prefill_kernel "packed")."""
    v = _committed("torch_eval_coati2_conditioning.json")
    assert "H100" in v["card"] and v["steps"] == 3000
    launches = v["launches"]
    assert launches["packed_causal_attention_backward"] == 2 * 3 * v["steps"]
    assert launches["packed_causal_attention"] > 2 * 3 * v["steps"]
    assert launches["decode_attention"] > 0
    means = [v["mean_length"][t] for t in ("5", "8", "11", "14")]
    assert v["monotone"] == all(a < b for a, b in zip(means, means[1:]))
    assert v["correlation"] == pytest.approx(np.corrcoef([5, 8, 11, 14], means)[0, 1])
    assert v["ok"] is (v["monotone"] and v["correlation"] >= 0.9)
    assert v["ok"] is True
