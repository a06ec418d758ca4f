"""coati_tpu_torch's COATI2 against coati_tpu's on the CPU, in float32
with the JAX side at precision "highest" (atol 3e-5, rtol 1e-4): the
three smiles_to_coati heads, greedy decoding with and without a
property-conditioned prefix, the fused round trip, both document formats,
the COATI2 training transform on every branch, the directCLR loss, the
training forward's loss and gradients, and one and three train_coati2
steps. Weights come from coati_tpu's init_coati2 and are carried across by
coati2_state_from_coati_tpu; models are 2 layers of 64 (Dh 16) or 128
(Dh 32, COATI2 grande's head size) with 4 heads."""

import dataclasses
import glob
import gzip
import os
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.data import xform_coati2 as j_x2
from coati_tpu.models import coati2 as j2
from coati_tpu.models.coati import ar_loss_fn as j_ar_loss
from coati_tpu.models.io import load_coati2 as jax_load_coati2
from coati_tpu.models.io import params_to_state
from coati_tpu.models.io import serialize_model as jax_serialize
from coati_tpu.parallel.mesh import make_mesh
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer
from coati_tpu.training import flops as jflops
from coati_tpu.training import train_coati2 as jt2
from coati_tpu.training.logger import COATILogger as JaxLogger

from coati_tpu_torch.data import xform_coati2 as t_x2
from coati_tpu_torch.data.batch_pipe import SmilesRows
from coati_tpu_torch.models import coati2 as t2
from coati_tpu_torch.models import extra_blocks as t_extra
from coati_tpu_torch.models.convert import coati2_state_from_coati_tpu
from coati_tpu_torch.models.io import load_coati2, load_model_doc, model_to_state
from coati_tpu_torch.models.transformer import Block
from coati_tpu_torch.ops.layers import rms_norm, swiglu
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training import flops as tflops
from coati_tpu_torch.training import train_coati2 as tt2
from coati_tpu_torch.training.logger import COATILogger
from tests import torch_port_helpers as hp

CORPUS = Path(__file__).resolve().parents[1] / "corpora" / "chembl_synth_v1.smi.gz"
SMILES = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "OC(=O)C1CC1", "N#CCC(=O)N",
          "CN1CCC(CC1)C(=O)O", "Clc1ccccc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]
PROPS = "[PROPS][PercentQED][NUM60][IntMolLogP][NUM12][ENDPROPS][SMILES]"
N_SEQ = 40
DECODE_SEQ = 28  # the decode tests' n_seq: a greedy decode runs to it


def _tok(n_seq=N_SEQ):
    return TrieTokenizer(n_seq=n_seq, **get_vocab("coati2_12_12"))


def _jtok(n_seq=N_SEQ):
    return JaxTokenizer(n_seq=n_seq, **get_vocab("coati2_12_12"))


def _pair(seed=0, width=64, enc="swiglu_resnet", n_seq=N_SEQ, **kw):
    """(jax params, jax config, port model, port config), the same weights:
    coati_tpu's init_coati2 carried across. The port model requires grad."""
    kwargs = dict(n_layer_xformer=2, n_hidden_xformer=width, embed_dim=width, n_head=4,
                  n_seq=n_seq, enc_to_coati=enc, n_direct_clr=16, n_tok=_tok(n_seq).n_token)
    kwargs.update(kw)
    jcfg = j2.Coati2Config(precision="highest", prefill_kernel="xla", **kwargs)
    jparams = j2.init_coati2(jax.random.PRNGKey(seed), jcfg)
    tcfg = t2.Coati2Config(**kwargs)
    model = t2.Coati2Model(tcfg)
    model.load_state_dict(coati2_state_from_coati_tpu(params_to_state(jparams), enc), strict=True)
    return jparams, jcfg, model, tcfg


def _token_rows(tok, smiles, width=None):
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.full((len(rows), width or tok.n_seq), tok.pad_token, np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


# ----------------------------------------------------------------- layers


def test_swiglu_rms_norm_and_plain_blocks_equal_coati_tpu_s():
    from coati_tpu.models import extra_blocks as j_extra
    from coati_tpu.ops import layers as j_layers

    x = np.random.default_rng(0).normal(size=(3, 5, 8)).astype(np.float32)
    hp.close(swiglu(hp.t(x)), j_layers.swiglu(jnp.asarray(x)))
    scale = np.linspace(0.5, 2.0, 8).astype(np.float32)
    hp.close(rms_norm(hp.t(x), hp.t(scale)), j_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    # a Block's reference state dict through both converters; causal and not
    block = Block(8, True)
    sd = {f"blk.{k}": v.detach().numpy() for k, v in block.state_dict().items()}
    jp = j_extra.convert_plain_block(sd, "blk.")
    mine = t_extra.convert_plain_block(sd, "blk.")
    with jax.default_matmul_precision("highest"):
        for causal in (True, False):
            want = j_extra.plain_block(jnp.asarray(x), jp, 2, causal)
            with torch.no_grad():
                hp.close(t_extra.plain_block(hp.t(x), mine, 2, causal), want)
        emb = j_extra.init_simple_token_embedding(jax.random.PRNGKey(1), 11, 6, 8)
    p = t_extra.SimpleTokenEmbedding(11, 6, 8)
    p.tok_emb.weight.data, p.pos_emb.weight.data = hp.t(emb.tok_emb), hp.t(emb.pos_emb)
    toks = np.array([[1, 2, 3, 10], [0, 0, 5, 4]])
    with torch.no_grad():
        hp.close(t_extra.simple_token_embedding(p, torch.tensor(toks)),
                 j_extra.simple_token_embedding(emb, jnp.asarray(toks)))


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("enc,width", [("linear", 64), ("swiglu_mlp", 64),
                                       ("swiglu_resnet", 64), ("swiglu_resnet", 128)])
def test_encode_tokens_equals_coati_tpu_s(enc, width):
    jparams, jcfg, model, tcfg = _pair(seed=1, width=width, enc=enc)
    tok = _tok()
    tokens = _token_rows(tok, SMILES)
    mine = t2.COATI2(model, tcfg).encode_tokens(tokens, tok)
    ref = j2.COATI2(jparams, jcfg).encode_tokens(tokens, _jtok())
    assert mine.shape == (len(SMILES), width)
    hp.close(mine, ref)
    vec = t2.COATI2(model, tcfg).smiles_to_coati_vec(SMILES[:3], tok)
    hp.close(vec, j2.COATI2(jparams, jcfg).smiles_to_coati_vec(SMILES[:3], _jtok()))


@pytest.mark.parametrize("width", [64, 128])
def test_greedy_decode_plain_and_conditioned_token_exact(width):
    """hcoati_to_2d_batch, greedy, token for token: the plain prefix, the
    suffix form, and a property-conditioned prefix."""
    jparams, jcfg, model, tcfg = _pair(seed=2, width=width, n_seq=DECODE_SEQ)
    tok, jtok = _tok(DECODE_SEQ), _jtok(DECODE_SEQ)
    mine_m, ref_m = t2.COATI2(model, tcfg), j2.COATI2(jparams, jcfg)
    h = np.asarray(ref_m.encode_tokens(_token_rows(jtok, SMILES[:6]), jtok))
    for kw in (dict(), dict(do_suffix=True), dict(fill_in_from=PROPS)):
        mine = mine_m.hcoati_to_2d_batch(h, tok, k=1, keep_special=True, return_tokens=True, **kw)
        ref = ref_m.hcoati_to_2d_batch(h, jtok, k=1, keep_special=True, return_tokens=True, **kw)
        assert mine == ref, kw
    prefix = tok.tokenize_text("[CLIP][UNK]" + PROPS, pad=False)
    assert all(row[: len(prefix)] == prefix for row in mine[1])
    assert mine_m.hcoati_to_2d(h[0], tok, k=1) == ref_m.hcoati_to_2d(h[0], jtok, k=1)


@pytest.mark.parametrize("fill_in_from", ["[SMILES]", PROPS])
def test_fused_round_trip_equals_two_calls_and_coati_tpu_s(fill_in_from):
    jparams, jcfg, model, tcfg = _pair(seed=3, width=128, n_seq=DECODE_SEQ)
    tok, jtok = _tok(DECODE_SEQ), _jtok(DECODE_SEQ)
    tokens = _token_rows(tok, SMILES[:5])
    m = t2.COATI2(model, tcfg)
    kw = dict(k=1, keep_special=True, fill_in_from=fill_in_from)
    smiles, h = m.smiles_to_2d_batch(tokens, tok, return_embeddings=True, **kw)
    assert smiles == m.hcoati_to_2d_batch(m.encode_tokens(tokens, tok), tok, **kw)
    ref, ref_h = j2.COATI2(jparams, jcfg).smiles_to_2d_batch(
        tokens, jtok, return_embeddings=True, **kw)
    assert smiles == ref
    hp.close(h, ref_h)
    # host noise: the same stream as coati_tpu's, call after call
    noisy = dict(kw, noise_scale=0.3)
    a, b = t2.COATI2(model, tcfg, seed=5), j2.COATI2(jparams, jcfg, seed=5)
    for _ in range(2):
        assert a.smiles_to_2d_batch(tokens, tok, **noisy) == b.smiles_to_2d_batch(
            tokens, jtok, **noisy)


@pytest.mark.parametrize("enc", ["linear", "swiglu_mlp", "swiglu_resnet"])
def test_load_coati2_reads_reference_port_and_coati_tpu_documents(enc, tmp_path):
    """A reference-format document (the port module's state dict, numpy)
    read by both packages' load_coati2, and coati_tpu's own nested document
    read by the port's: every model encodes alike. The loader puts the model
    where it is told, frozen."""
    jparams, _, model, tcfg = _pair(seed=4, enc=enc)
    tok = _tok()
    kwargs = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg)
              if f.name in ("n_layer_xformer", "n_hidden_xformer", "embed_dim", "n_head",
                            "n_seq", "enc_to_coati", "n_direct_clr", "n_tok", "biases")}
    flat = tmp_path / "reference.pkl"
    flat.write_bytes(jax_serialize(train_args={"tokenizer_vocab": "coati2_12_12"},
                                   dataset_summary={}, model_state=model_to_state(model),
                                   model_kwargs=kwargs))
    nested = tmp_path / "nested.pkl"
    nested.write_bytes(jax_serialize(train_args={"tokenizer_vocab": "coati2_12_12"},
                                     dataset_summary={}, model_state=params_to_state(jparams),
                                     model_kwargs=kwargs))
    tokens = _token_rows(tok, SMILES)
    jm, jtok = jax_load_coati2(str(flat))
    jm = j2.COATI2(jm.params, jm.config.replace(precision="highest"))
    want = jm.encode_tokens(tokens, jtok)
    for path in (flat, nested):
        m, mtok = load_coati2(str(path), device="cpu")
        assert m.config == tcfg and mtok.n_token == tok.n_token and m.device.type == "cpu"
        assert not any(p.requires_grad for p in m.params.parameters())
        hp.close(m.encode_tokens(tokens, mtok), want)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_available = torch.cuda.is_available
        try:
            torch.cuda.is_available = lambda: False
            load_coati2(str(flat))
        finally:
            torch.cuda.is_available = torch_available
    assert load_coati2(str(flat), force_cpu=True)[0].device.type == "cpu"


# -------------------------------------------------------------- transform


def _xform_rows():
    """Corpus rows, a row too long for the width, one whose conditioning
    block overflows it, one the tokenizer refuses, and a stereocentre."""
    corpus = gzip.open(CORPUS, "rt").read().split()
    tok = _tok()
    lengths = [len(tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False, range_check=False))
               for s in corpus[:400]]
    too_long = next(s for s, n in zip(corpus, lengths) if n > N_SEQ)
    near_full = next(s for s, n in zip(corpus, lengths) if N_SEQ - 1 <= n <= N_SEQ)
    return corpus[:10] + [too_long, near_full, "CC!", "N[C@@H](C)C(=O)O"]


XFORM_CASES = {
    "props": dict(p_props=1.0, p_prop_each=0.5, p_clip=1.0, p_dataset=0.0),
    "dataset": dict(p_props=0.0, p_clip=0.9, p_dataset=1.0),
    "no_clip": dict(p_props=0.5, p_clip=0.0, p_dataset=0.5),
    "columns": dict(p_props=1.0, p_prop_each=1.0, p_clip=0.9, p_dataset=0.5),
}


@pytest.mark.parametrize("case", sorted(XFORM_CASES))
def test_coati2_ar_xform_gives_coati_tpu_s_batch_from_the_same_seed(case):
    rows = _xform_rows()
    out = []
    for package, tokenizer in ((t_x2, _tok()), (j_x2, _jtok())):
        batch = {"smiles": list(rows), "source_collection": ["chembl_mols"] * len(rows)}
        if case == "columns":
            batch["properties"] = [None] * len(rows)
            batch["properties"][0] = {"QED": 0.5, "MolLogP": 1.2, "TPSA": 40.0}
            batch["rand_smiles"] = [""] * len(rows)
            batch["rand_smiles"][1] = "OCC"
            batch["purchasable"] = [i % 2 for i in range(len(rows))]
            batch["fda_approved"] = [i % 3 == 0 for i in range(len(rows))]
        random.seed(9)
        got = package.coati2_ar_xform(batch, tokenizer, rng=random.Random(10),
                                      **XFORM_CASES[case])
        out.append((got, random.getstate()))
    (mine, state_t), (ref, state_j) = out
    assert state_t == state_j  # permute_smiles drew from the global random alike
    for key in ("tokens", "raw_tokens", "rand_tokens", "y_next"):
        np.testing.assert_array_equal(mine[key], ref[key], err_msg=key)
    tok = _tok()
    assert mine["raw_tokens"].shape == mine["rand_tokens"].shape
    assert mine["tokens"].shape[1] <= N_SEQ
    # the row too long for the width and the refused one are all [PAD] (31)
    assert tok.pad_token == 31
    for bad in (10, 12):
        assert (mine["tokens"][bad] == 31).all() and (mine["y_next"][bad] == -1).all()
    if case == "props":  # a corpus row starts with its conditioning block or [CLIP]...
        starts = tok.tokenize_text("[PROPS][CLIP]", pad=False)
        assert set(mine["tokens"][:10, 0]) <= set(starts)
        # ...but the near-full row falls back to its plain [SMILES] row
        raw = mine["raw_tokens"][11]
        n = int((raw != 31).sum())
        assert list(mine["tokens"][11][:n]) == list(raw[:n])
        assert (mine["tokens"][11][n:] == 31).all()


# --------------------------------------------------------------- training


def _train_batch(tok, rows, seed):
    random.seed(seed)
    batch = t_x2.coati2_ar_xform({"smiles": list(rows)}, tok, p_props=0.7, p_clip=0.7,
                                 rng=random.Random(seed))
    return {k: batch[k] for k in tt2.BATCH_KEYS}


def test_direct_clr_loss_equals_coati_tpu_s():
    rng = np.random.default_rng(5)
    h1, h2 = rng.normal(size=(2, 6, 24)).astype(np.float32)
    bad = np.array([False, True, False, False, True, False])
    for n, inv_temp in ((16, 10.0), (24, 3.0)):
        mine = t2.direct_clr_loss(hp.t(h1), hp.t(h2), torch.tensor(bad), n, inv_temp)
        ref = j2.direct_clr_loss(jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(bad), n, inv_temp)
        hp.close(mine, ref)


@pytest.mark.parametrize("width", [64, 128])
def test_training_forward_loss_and_gradients_equal_coati_tpu_s(width):
    jparams, jcfg, model, tcfg = _pair(seed=6, width=width)
    tok = _tok()
    batch = _train_batch(tok, SMILES, 11)
    assert (batch["tokens"] == tok.pad_token).any()
    unit = float(np.log2(tok.n_token))
    kw = dict(stop_token=tok.stop_token, unk_token=tok.unk_token, pad_token=tok.pad_token)

    def jloss(params):
        h1, h2, logits, bad = j2.coati2_training_forward(
            params, jcfg, jnp.asarray(batch["tokens"]), jnp.asarray(batch["raw_tokens"]),
            jnp.asarray(batch["rand_tokens"]), tok.stop_token, tok.unk_token, tok.pad_token)
        ar = j_ar_loss(logits, jnp.asarray(batch["y_next"]))
        return ar + j2.direct_clr_loss(h1, h2, bad, jcfg.n_direct_clr) * unit

    ref, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams)
    step = tt2.Coati2TrainStep(model, tcfg, None, token_entropy_unit=unit, **kw)
    loss, ar, cl = step.losses({k: torch.tensor(v, dtype=torch.long) for k, v in batch.items()})
    hp.close(loss, ref)
    loss.backward()
    want = {k: v.numpy() for k, v in coati2_state_from_coati_tpu(
        params_to_state(jgrads), tcfg.enc_to_coati).items()}
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=hp.ATOL, rtol=hp.RTOL,
                                   err_msg=name)


def test_config_model_kwargs_and_flops_follow_coati_tpu():
    mine, ref = tt2.Coati2TrainConfig(), jt2.Coati2TrainConfig()
    assert mine.as_dict() == ref.as_dict()
    assert mine.model_kwargs(4266) == ref.model_kwargs(4266)
    cfg = mine.model_config(4266)
    assert cfg.prefill_kernel == "packed" and ref.model_config(4266).prefill_kernel == "xla"
    assert tt2.Coati2TrainConfig(n_seq=200).model_config(4266).prefill_kernel == "auto"
    for f in ("n_layer_xformer", "n_hidden_xformer", "embed_dim", "n_head", "n_seq",
              "enc_to_coati", "n_direct_clr", "remat"):
        assert getattr(cfg, f) == getattr(ref.model_config(4266), f), f
    kw = dict(n_layer_xformer=16, n_hidden_xformer=512, n_tok=4266, batch=160, seq=128)
    assert tflops.coati2_train_step_model_flops(**kw) == jflops.coati2_train_step_model_flops(**kw)
    for field, value in (("parallel_mode", "shard_map"), ("param_sharding", "fsdp")):
        with pytest.raises(NotImplementedError, match="one device"):
            tt2.train_coati2(tt2.Coati2TrainConfig(**{field: value}), None, device="cpu")
    with pytest.raises(NotImplementedError, match="orbax_dir"):
        tt2.train_coati2(tt2.Coati2TrainConfig(orbax_dir="x"), None, device="cpu")


@pytest.mark.parametrize("steps", [1, 3])
def test_train_coati2_steps_track_coati_tpu_s(tmp_path, steps):
    """Both packages' train_coati2 from one coati_tpu document on the same
    rows, the global random module seeded alike before each run: each step's
    loss, ar_loss and clr_loss agree within atol 3e-5, rtol 1e-4, the token
    counts are equal, and the weights after the last step agree within
    3 * lr everywhere, within 1e-3 * lr for 99% of them and for 95% of each
    tensor's, and give the reference's losses on rows of no training batch.
    Adam's first steps amplify last-bit differences of gradients near zero
    (as in test_torch_training.py; the key bias of c_attn has a zero
    gradient in exact arithmetic), and both packages' CPU gradients vary in
    their last bits from run to run (threaded sums), so the share of
    amplified elements varies too: 0.9983 to 0.99999 within 1e-3 * lr over
    six runs, and at most 1.6% of one tensor (3 of a c_attn bias's 192,
    1 of a LayerNorm's 64) over fourteen runs of three steps."""
    kwargs = dict(n_layer_xformer=2, n_hidden_xformer=64, embed_dim=64, n_head=4, n_seq=48,
                  n_direct_clr=16)
    jparams, _, _, _ = _pair(seed=7, **{k: v for k, v in kwargs.items() if k != "n_seq"},
                             n_seq=48)
    start = tmp_path / "start.pkl"
    start.write_bytes(jax_serialize(train_args={}, dataset_summary={},
                                    model_state=params_to_state(jparams), model_kwargs={}))
    corpus = gzip.open(CORPUS, "rt").read().split()
    data = SmilesRows(corpus[:8 * steps])
    docs = {}
    for name, config_cls, logger_cls in (("mine", tt2.Coati2TrainConfig, COATILogger),
                                         ("ref", jt2.Coati2TrainConfig, JaxLogger)):
        config = config_cls(batch_size=8, n_epochs=1, lr=1e-3, log_batch_loss=1,
                            output_dir=str(tmp_path / name), resume_document=str(start),
                            **kwargs)
        model_dir = str(tmp_path / name / "models")
        logger = logger_cls(model_name="coati2", output_path=config.output_dir,
                            model_path=model_dir, args=config.as_dict())
        logger.start()
        random.seed(12)
        if name == "mine":
            model, results = tt2.train_coati2(config, data, device="cpu", logger=logger,
                                              max_steps_per_epoch=steps)
        else:
            out, _ = jt2.train_coati2(config, data, mesh=make_mesh(1), logger=logger,
                                      max_steps_per_epoch=steps)
        docs[name] = load_model_doc(sorted(glob.glob(os.path.join(model_dir, "*")))[-1])
        logger.stop()
    mine, ref = docs["mine"], docs["ref"]
    assert mine["n_toks_processed"] == ref["n_toks_processed"] > 0
    assert len(results["history"]) == steps and len(results["train_step_seconds"]) == steps
    for key in ("batch_losses", "ar_losses", "clip_losses"):
        got, want = ([(e["step"], e["tag_n_toks"], e["value"]) for e in doc["offline_loss"][key]]
                     for doc in (mine, ref))
        assert len(got) == steps and [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                                   atol=hp.ATOL, rtol=hp.RTOL, err_msg=key)
    want = coati2_state_from_coati_tpu(params_to_state(out), "swiglu_resnet")
    diffs = {n: (p.detach() - want[n]).abs() for n, p in model.named_parameters()}
    flat = torch.cat([d.flatten() for d in diffs.values()])
    assert float(flat.max()) <= 3 * 1e-3
    assert float((flat <= 1e-3 * 1e-3).float().mean()) >= 0.99
    # per tensor too: a whole tensor's wrong update would fit in 1% of all weights
    for n, d in diffs.items():
        assert float((d <= 1e-3 * 1e-3).float().mean()) >= 0.95, n
    # the updated weights evaluate alike on rows that no step trained on
    tok = _tok(kwargs["n_seq"])
    model_cfg = tt2.Coati2TrainConfig(**kwargs).model_config(tok.n_token)
    held_out = t_x2.coati2_ar_xform({"smiles": corpus[200:216]}, tok, rng=random.Random(0))
    batch = tt2.batch_to_device(held_out, torch.device("cpu"))
    updated = t2.Coati2Model(model_cfg)
    updated.load_state_dict(want, strict=True)
    losses = []
    for m in (model, updated):
        step = tt2.Coati2TrainStep(m.eval(), model_cfg, None, stop_token=tok.stop_token,
                                   unk_token=tok.unk_token, pad_token=tok.pad_token,
                                   token_entropy_unit=float(np.log2(tok.n_token)))
        with torch.no_grad():
            losses.append(torch.stack(step.losses(batch)))
    hp.close(*losses)
    # the run's document loads in the port and in coati_tpu, and encodes alike
    path = tmp_path / "mine.pkl"
    path.write_bytes(jax_serialize(**{k: mine[k] for k in (
        "train_args", "dataset_summary", "model_kwargs")}, model_state=mine["model"]))
    m, tok = load_coati2(str(path), device="cpu")
    jm, jtok = jax_load_coati2(str(path))
    jm = j2.COATI2(jm.params, jm.config.replace(precision="highest"))
    tokens = _token_rows(tok, SMILES[:4])
    hp.close(m.encode_tokens(tokens, tok), jm.encode_tokens(tokens, jtok))
