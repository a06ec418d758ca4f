"""DeepSeek-V2-Lite's block as COATI's trunk (coati_tpu_torch/models/mla_moe.py,
ops/moe.py, K6's plain version) against the plain float32 reference
(tests/reference_mla_moe.py) at a small size on the CPU, seeded weights,
within the repository's atol 3e-5 / rtol 1e-4 unless a test says why."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from coati_tpu_torch.common import tracing
from coati_tpu_torch.models import mla_moe, transformer, trunks
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.coati import CoatiConfig, CoatiModel
from coati_tpu_torch.models.mla_moe import MlaMoeConfig
from coati_tpu_torch.ops import moe
from coati_tpu_torch.ops.kernels.mla_decode import mla_decode, mla_decode_plain
from coati_tpu_torch.ops.rotary import yarn_correction_range
from tests import reference_mla_moe as ref
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 3e-5, 1e-4
SMALL = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             dense_width=96, expert_width=24, n_routed=16, top_k=6, n_shared=2,
             first_expert=4, n_held=8)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def small_config(**mla) -> CoatiConfig:
    return CoatiConfig(n_layer_e3gnn=1, n_layer_xformer=3, n_hidden_xformer=64, n_hidden_e3nn=16,
                       n_embd_common=32, n_head=4, n_seq=24, n_tok=50,
                       mla=MlaMoeConfig(**{**SMALL, **mla}))


def ref_config(cfg: CoatiConfig) -> dict:
    """The reference's configuration: the published config's keys."""
    m = cfg.xformer_config
    return {"hidden_size": m.n_embd, "num_attention_heads": m.n_head,
            "kv_lora_rank": m.kv_lora_rank, "qk_nope_head_dim": m.qk_nope_head_dim,
            "qk_rope_head_dim": m.qk_rope_head_dim, "v_head_dim": m.v_head_dim,
            "intermediate_size": m.dense_width, "moe_intermediate_size": m.expert_width,
            "n_routed_experts": m.n_held, "router_width": m.n_routed,
            "first_expert": m.first_expert, "num_experts_per_tok": m.top_k,
            "n_shared_experts": m.n_shared, "first_k_dense_replace": m.n_dense,
            "num_hidden_layers": m.n_layer, "rms_norm_eps": m.rms_eps, "rope_theta": m.rope_theta,
            "rope_scaling": {"factor": m.yarn_factor, "original_max_position_embeddings":
                             m.yarn_original, "beta_fast": m.yarn_beta_fast,
                             "beta_slow": m.yarn_beta_slow, "mscale": m.yarn_mscale,
                             "mscale_all_dim": m.yarn_mscale_all_dim, "type": "yarn"},
            "vocab_size": m.n_tok, "n_embd_common": cfg.n_embd_common}


def seeded_model(cfg: CoatiConfig, seed: int = 0):
    """The model with PyTorch's initialisation from `seed`, its norms moved
    off 1 so that they count; (params, the reference's weights)."""
    torch.manual_seed(seed)
    params = CoatiModel(cfg)
    with torch.no_grad():
        for name, p in params.named_parameters():
            if "layernorm" in name or name.endswith("norm.weight"):
                p.uniform_(0.5, 1.5)
    params.requires_grad_(False)
    return params, {k: v.clone() for k, v in params.state_dict().items()}


def close(a, b, atol=ATOL, rtol=RTOL):
    torch.testing.assert_close(a, b, atol=atol, rtol=rtol)


def tokens_of(cfg, b=3, t=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(4, cfg.n_tok, (b, t), generator=g)


# ------------------------------------------------------------ constants


def test_yarn_constants_are_the_published():
    published = MlaMoeConfig()
    assert yarn_correction_range(32, 1, 64, 10000.0, 4096) == (10, 23)
    assert published.softmax_scale == pytest.approx(0.114721, abs=5e-7)
    cfg = ref_config(CoatiConfig(n_hidden_xformer=2048, n_head=16, n_tok=13603,
                                 mla=MlaMoeConfig()))
    assert ref.yarn_range(cfg) == (10, 23)
    assert ref.softmax_scale(cfg) == pytest.approx(0.114721, abs=5e-7)
    cos, sin = mla_moe.decode_tables(published, "cpu")
    rcos, rsin = ref.rope_tables(cfg, 250, "cpu")
    close(cos, rcos, atol=1e-6, rtol=0)
    close(sin, rsin, atol=1e-6, rtol=0)


def test_top_k_takes_the_lower_index_among_equals():
    d = 8
    router = torch.zeros(16, d)
    router[[2, 3, 7, 9, 11]] = 1.0  # five best, equal
    router[[5, 12]] = 0.5  # the sixth place tied between 5 and 12
    weights, experts = moe.route(torch.ones(1, d), router, 6)
    assert experts.tolist() == [[2, 3, 7, 9, 11, 5]]
    assert (weights[0, :5] == weights[0, 0]).all()
    _, rexperts = ref.route(torch.ones(1, d), router, 6)
    assert rexperts.tolist() == experts.tolist()


# --------------------------------------------------------------- trunk


def test_encode_hidden_state_matches_the_reference():
    cfg = small_config()
    params, w = seeded_model(cfg)
    tok = tokens_of(cfg)
    assert trunks.of(cfg.xformer_config) is mla_moe
    assert trunks.of(cfg.replace(mla=None).xformer_config) is transformer
    got = mla_moe.forward_hidden(params.xformer, cfg.xformer_config, tok)
    close(got, ref.trunk_hidden(w, ref_config(cfg), tok))


def test_prefill_and_decode_through_the_latent_cache_match_the_full_forward():
    cfg = small_config()
    xcfg = cfg.xformer_config
    params, w = seeded_model(cfg, seed=3)
    tok = tokens_of(cfg, t=14, seed=2)
    unk, p = 7, 4
    tok[:, 1] = unk
    inj = torch.randn(tok.shape[0], xcfg.n_embd, generator=torch.Generator().manual_seed(5))
    marked = torch.where(torch.arange(tok.shape[1])[None] < p, tok, -1)
    want = ref.lm_logits(w, ref.trunk_hidden(w, ref_config(cfg), tok, inj, unk, inject_at=marked))
    hidden, cache = mla_moe.prefill(params.xformer, xcfg, tok[:, :p], injection=inj,
                                    inject_token=unk)
    assert isinstance(cache, mla_moe.LatentCache) and cache.data.shape[-1] == 40
    close(hidden @ params.xformer.lm_head.weight.t(), want[:, :p])
    tables = mla_moe.decode_tables(xcfg, "cpu")
    for pos in range(p, tok.shape[1]):
        if pos % 2:  # the host-int step and the device-position step alike
            logits, cache = mla_moe.decode_step(params.xformer, xcfg, tok[:, pos], pos, cache)
        else:
            logits, cache = mla_moe.decode_step_at(
                params.xformer, xcfg, tok[:, pos], torch.tensor([pos], dtype=torch.int32),
                cache, tables)
        close(logits, want[:, pos])


def test_absorbed_decode_equals_the_full_form_of_the_port():
    cfg = small_config(n_held=16, first_expert=0)
    xcfg = cfg.xformer_config
    params, _ = seeded_model(cfg, seed=4)
    tok = tokens_of(cfg, t=10, seed=6)
    full = mla_moe.forward_hidden(params.xformer, xcfg, tok) @ params.xformer.lm_head.weight.t()
    _, cache = mla_moe.prefill(params.xformer, xcfg, tok[:, :1])
    for pos in range(1, tok.shape[1]):
        logits, cache = mla_moe.decode_step(params.xformer, xcfg, tok[:, pos], pos, cache)
        close(logits, full[:, pos])


def test_k6_plain_version_matches_per_head_attention():
    g = torch.Generator().manual_seed(8)
    b, h, t, lat, r, pos, scale = 3, 4, 20, 32, 8, 13, 0.3
    q, cache = torch.randn(b, h, lat + r, generator=g), torch.randn(b, t, lat + r, generator=g)
    out = mla_decode(q, cache, pos, scale, lat)
    assert torch.equal(out, mla_decode_plain(q, cache, torch.tensor([pos], dtype=torch.int32),
                                             scale, lat))
    for i in range(b):
        for j in range(h):
            s = torch.stack([scale * (q[i, j] @ cache[i, k]) for k in range(pos + 1)])
            want = sum(pk * cache[i, k, :lat] for k, pk in enumerate(s.softmax(0)))
            close(out[i, j], want)


# ------------------------------------------------------------- experts


def _dense_loop(x, experts, weights, first, gate_up, down):
    """Each held expert over every token that picked it, token by token."""
    y = torch.zeros(x.shape[0], down.shape[1])
    for n in range(x.shape[0]):
        for slot in range(experts.shape[1]):
            e = int(experts[n, slot]) - first
            if 0 <= e < gate_up.shape[0]:
                gate, up = (gate_up[e] @ x[n]).chunk(2)
                y[n] += weights[n, slot] * (down[e] @ (torch.nn.functional.silu(gate) * up))
    return y


@pytest.mark.parametrize("case", ["routed", "all_on_one_expert"])
def test_grouped_expert_product_matches_a_dense_per_expert_loop(case):
    g = torch.Generator().manual_seed(9)
    n, d, w, n_held, first, k = 40, 16, 12, 4, 2, 3
    x = torch.randn(n, d, generator=g)
    gate_up, down = torch.randn(n_held, 2 * w, d, generator=g), torch.randn(n_held, d, w, generator=g)
    if case == "routed":
        weights, experts = moe.route(x, torch.randn(10, d, generator=g), k)
    else:  # dropless: every token's first pick on one held expert, the rest held elsewhere
        experts = torch.full((n, k), 9)
        experts[:, 0] = first + 1
        weights = torch.rand(n, k, generator=g)
    order, ends, held = moe.dispatch(experts, first, n_held)
    if case == "all_on_one_expert":
        assert ends.tolist() == [0, n, n, n]
    ys = moe.grouped_swiglu(x[order // k], ends, gate_up, down)
    y = torch.zeros(n * k, d).index_copy_(0, order, ys).view(n, k, d)
    got = torch.where(held[..., None], y * weights[..., None], 0.0).sum(1)
    close(got, _dense_loop(x, experts, weights, first, gate_up, down), atol=1e-4)


def test_eight_expert_shares_add_up_to_the_whole_layer():
    # one chip's share of an expert-parallel layer: the held experts' parts of
    # eight disjoint shares, with the shared expert counted once, are the
    # uncut layer's output
    cfg = small_config(n_held=16, first_expert=0)
    params, w = seeded_model(cfg, seed=11)
    rc = ref_config(cfg)
    x = torch.randn(30, cfg.n_hidden_xformer, generator=torch.Generator().manual_seed(12))
    p = "xformer.layers.1."
    whole = ref.moe(w, p, rc, x)
    shared = ref._swiglu(x, w[p + "mlp.shared_experts.gate_up_proj.weight"],
                         w[p + "mlp.shared_experts.down_proj.weight"], ref.EXACT)
    total = shared.clone()
    mlp = params.xformer.layers[1].mlp
    for first in range(0, 16, 2):
        part = moe.expert_layer(x, mlp.gate.weight, mlp.experts.gate_up[first: first + 2],
                                mlp.experts.down[first: first + 2], None, None, 6, first)
        total += part
        sw = dict(w, **{p + "mlp.experts.gate_up": w[p + "mlp.experts.gate_up"][first: first + 2],
                        p + "mlp.experts.down": w[p + "mlp.experts.down"][first: first + 2]})
        close(part + shared, ref.moe(sw, p, dict(rc, n_routed_experts=2, first_expert=first), x))
    close(total, whole)


def test_the_two_reference_copies_give_the_same_logits():
    from portbench.reference import mla_moe as bench_ref

    cfg = small_config()
    _, w = seeded_model(cfg, seed=13)
    rc = ref_config(cfg)
    tok = tokens_of(cfg, seed=14)
    tok[:, 3] = 2  # a [STOP]
    h = ref.embed(w, rc, tok, 2)
    assert torch.equal(h, bench_ref.embed(w, rc, tok, 2))
    assert torch.equal(ref.decode_logits(w, rc, h, tok, 1, 3),
                       bench_ref.decode_logits(w, rc, h, tok, 1, 3))


# ------------------------------------------------------------------ API


def test_the_coati_handle_serves_the_trunk_and_publishes_its_counters():
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    vocab = get_vocab("mar")
    n_tok = len(vocab["special_tokens"]) + len(vocab["smiles_tokens"])
    cfg = small_config().replace(n_tok=n_tok, n_seq=32)
    params, w = seeded_model(cfg, seed=15)
    tok = TrieTokenizer(n_seq=cfg.n_seq, **vocab)
    rows = np.asarray([tok.tokenize_text(f"[SMILES]{s}[STOP]", pad=True)
                       for s in ("CCO", "c1ccccc1", "CC(=O)N")])
    model = COATI(params, cfg, seed=0)
    got = model.encode_tokens(rows, tok)
    close(got, ref.embed(w, ref_config(cfg), torch.as_tensor(rows), tok.stop_token))
    tracing.reset()
    tracing.start()
    try:
        out = model.smiles_to_2d_batch(rows, tok, k=1)
    finally:
        tracing.stop()
    counters = tracing.snapshot()["counters"]
    tracing.reset()
    assert len(out) == 3 and all(isinstance(s, str) for s in out)
    per_expert = sum(v for k, v in counters.items() if k.startswith("moe.expert_tokens."))
    assert counters["moe.pairs_here"] == per_expert > 0
    assert counters["moe.passes"] >= 2 * (cfg.n_seq - 3)  # two expert layers, every step
    assert counters["moe.peak_over_mean_ppm"] >= 1e6 * counters["moe.passes"]
    assert not params.xformer.moe_tokens.any()  # read and zeroed once the call was done


def test_a_document_of_the_trunk_loads_through_the_coati_loader():
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    cfg = small_config().replace(n_tok=13603)
    params, w = seeded_model(cfg, seed=16)
    kwargs = {k: getattr(cfg, k) for k in ("n_layer_e3gnn", "n_layer_xformer", "n_hidden_xformer",
                                           "n_hidden_e3nn", "n_embd_common", "n_head", "n_seq",
                                           "n_tok")}
    kwargs["mla"] = json.loads(json.dumps(cfg.mla.__dict__))
    doc = {"model": w, "model_kwargs": kwargs, "train_args": {"tokenizer_vocab": "mar"}}
    loaded, _ = load_e3gnn_smiles_clip_e2e(doc, device="cpu")
    assert loaded.config.xformer_config == cfg.xformer_config
    tok = tokens_of(cfg)
    close(mla_moe.forward_hidden(loaded.params.xformer, loaded.config.xformer_config, tok),
          mla_moe.forward_hidden(params.xformer, cfg.xformer_config, tok), atol=0, rtol=0)


# ---------------------------------------------------------------- costs


def test_the_benchmarks_cost_functions_against_a_hand_count():
    from portbench.costs import mla_moe as costs

    # K6 at B 1024, pos 95, 16 heads: 96 latent rows of 576 bf16 values a
    # row, q (16 x 576) and o_lat (16 x 512)
    assert costs.k6_bytes(1024, 95, 16, 512, 64) == 1024 * 2 * (96 * 576 + 16 * 576 + 16 * 512)
    assert costs.k6_ops(1024, 95, 16, 512, 64) == 1024 * 16 * 96 * (2 * 576 + 2 * 512)
    assert costs.k6_s(1024, 95, 16, 512, 64) == pytest.approx(148_897_792 / 3.35e12)
    # 708 pairs over 8 active held experts of 2048 x 1408
    assert costs.expert_bytes(708, 8, 2048, 1408) == 2 * (8 * 3 * 2048 * 1408 + 708 * (4096 + 4224))
    assert costs.expert_ops(708, 2048, 1408) == 708 * 3 * 2 * 2048 * 1408
    cfg = {"hidden_size": 8, "num_attention_heads": 2, "qk_nope_head_dim": 3, "qk_rope_head_dim": 2,
           "v_head_dim": 4, "kv_lora_rank": 5, "num_hidden_layers": 3, "first_k_dense_replace": 1,
           "intermediate_size": 7, "moe_intermediate_size": 6, "num_experts_per_tok": 2,
           "n_routed_experts": 2, "router_width": 4, "n_shared_experts": 1, "vocab_size": 11,
           "n_embd_common": 3}
    # one row of 2 tokens, in multiply-adds: per token and layer q 8*2*5,
    # kv_a 8*7, kv_b 5*2*7, o 2*4*8; attention over 1 then 2 keys, 2 heads of
    # 5 + 4; FFN: dense 3*8*7, then two expert layers of router 8*4, shared
    # 3*8*6 and 2*2/4 = 1 pair of 3*8*6
    proj = 80 + 56 + 70 + 64
    ffn = 3 * 8 * 7 + 2 * (8 * 4 + 3 * 8 * 6 + 3 * 8 * 6)
    attn = 3 * (1 + 2) * 2 * 9
    assert costs.full_flops([2], cfg) == pytest.approx(2 * (2 * 3 * proj + 2 * ffn + attn))
    # a decode step at position 4: q, kv_a, q_lat 2*3*5, W_UV 2*5*4 and o; 5
    # keys of 2 * 5 + 2 for 2 heads; the FFN; the head 8*11
    step = 3 * (80 + 56 + 30 + 40 + 64 + 5 * 2 * 12) + ffn + 88
    assert costs.decode_flops([4], cfg) == pytest.approx(2 * step)
