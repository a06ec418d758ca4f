"""coati_tpu_torch composite model, sampler, API and IO against coati_tpu
on the CPU: weights carried across both ways, encode and the clip-token
MLP, greedy generation token for token, the embed -> decode round trip
with shared host noise, and the trained grande document
docs/eval_model_r5.pkl.

Tolerance atol 3e-5, rtol 1e-4 (float32 summation order) unless a line
says otherwise; the JAX side runs at precision="highest"."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.models import coati as jco
from coati_tpu.models import sampler as jsm
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.convert import export_coati
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load
from coati_tpu.models.io import params_to_state, serialize_model

from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import sampler as tsm
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.convert import model_from_state, state_from_coati_tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

ATOL, RTOL = 3e-5, 1e-4
DOC = Path(__file__).resolve().parents[1] / "docs" / "eval_model_r5.pkl"
SMILES = [
    "CC(=O)Oc1ccccc1C(=O)O",
    "CN1C=NC2=C1C(=O)N(C(=O)N2C)C",
    "CC(C)Cc1ccc(cc1)C(C)C(=O)O",
    "c1ccc2c(c1)cccn2",
    "OCC1OC(O)C(O)C(O)C1O",
    "CC(C)NCC(O)c1ccc(O)c(O)c1",
    "CC1=CC(=O)C=CC1=O",
    "NC(=O)c1ccc(N)cc1",
]


def _close(mine, ref, atol=ATOL, rtol=RTOL):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    np.testing.assert_allclose(mine, np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _small(old_architecture=False, seed=0, **kw):
    """A small random COATI in both packages, on the 'mar_verysimple' vocab."""
    tok = TrieTokenizer(n_seq=48, **get_vocab("mar_verysimple"))
    kwargs = dict(
        n_layer_e3gnn=1, n_layer_xformer=2, n_hidden_xformer=32, n_hidden_e3nn=16,
        n_embd_common=32, n_head=2, n_seq=48, n_tok=tok.n_token, norm_clips=True,
        token_mlp=True, old_architecture=old_architecture, **kw,
    )
    jcfg = jco.CoatiConfig(precision="highest", prefill_kernel="xla", **kwargs)
    jparams = jco.init_coati(jax.random.PRNGKey(seed), jcfg)
    tcfg = tco.CoatiConfig(**kwargs)
    model = tco.CoatiModel(tcfg)
    model.load_state_dict(
        state_from_coati_tpu(params_to_state(jparams), old_architecture), strict=True
    )
    model.requires_grad_(False)
    return jparams, jcfg, model, tcfg, tok


def _smiles_tokens(tok, smiles, width=None):
    rows = [tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=False) for s in smiles]
    out = np.zeros((len(rows), width or tok.n_seq), np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


SMALL_SMILES = ["CCO", "CC", "CCCN", "CNC(C)O"]


@pytest.mark.parametrize("old_architecture", [False, True])
def test_weights_carried_across_encode_and_clip_token(old_architecture):
    jparams, jcfg, model, tcfg, tok = _small(old_architecture, seed=1)
    toks = _smiles_tokens(tok, SMALL_SMILES)
    jh = jco.encode_tokens(jparams, jcfg, jnp.asarray(toks), tok.stop_token)
    h = tco.encode_tokens(model, tcfg, torch.tensor(toks, dtype=torch.long), tok.stop_token)
    _close(h, jh)
    _close(tco.clip_to_special_token(model, h), jco.clip_to_special_token(jparams, jh))


@pytest.mark.parametrize(
    "old_architecture,fp_map", [(False, None), (True, None), (False, (("morgan", 24),))]
)
def test_export_coati_loads_strict_and_equals_nested_conversion(old_architecture, fp_map):
    """The reference-format flat dict of coati_tpu's export_coati loads
    strictly, and gives the same tensors as the nested-format path; so do
    the fingerprint heads of the fp variant."""
    jparams, jcfg, model, tcfg, _ = _small(old_architecture, seed=2, fp_map=fp_map)
    flat = export_coati(jparams, jcfg)
    other, cfg = model_from_state(tcfg.replace(fp_map=None), flat)
    assert cfg.fp_map == fp_map
    mine = model.state_dict()
    assert set(other.state_dict()) == set(mine) == set(flat)
    for key, value in other.state_dict().items():
        assert torch.equal(value, mine[key]), key


def test_generate_tokens_greedy_token_exact_and_staged_equals_single():
    jparams, jcfg, model, tcfg, tok = _small(seed=3)
    b, total = 6, 48
    prefix = tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False)
    inj = np.random.default_rng(4).normal(size=(b, tcfg.embed_dim)).astype(np.float32)
    pre = np.zeros((b, total), np.int32)
    pre[:, : len(prefix)] = prefix
    common = dict(
        prefill_len=len(prefix), total_len=total, stop_token=tok.stop_token,
        pad_token=tok.pad_token, k=1, inv_temp=1.0, inject_token=tok.unk_token,
    )
    ref = jsm.generate_tokens(
        jparams.xformer, jcfg.xformer_config, jax.random.PRNGKey(0), jnp.asarray(pre),
        jnp.full((b,), len(prefix), jnp.int32), inj_payload=jnp.asarray(inj),
        approx_top_k=False, **common,
    )
    gen = functools.partial(
        tsm.generate_tokens, model.xformer, tcfg.xformer_config, None, torch.tensor(pre),
        torch.full((b,), len(prefix)), inj_payload=torch.tensor(inj), **common,
    )
    single = gen()
    np.testing.assert_array_equal(single.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(gen(stage_widths=(16, 32, 48)).numpy(), single.numpy())
    with pytest.raises(ValueError):
        gen(stage_widths=(32, 16, 48))
    batch = tsm.generate_with_injection_batch(
        model.xformer, tcfg.xformer_config, None, prefix, torch.tensor(inj),
        stop_token=tok.stop_token, pad_token=tok.pad_token, unk_token=tok.unk_token,
        k=1, inv_temp=1.0, total_len=total,
    )
    np.testing.assert_array_equal(batch.numpy(), single.numpy())


def test_variable_prefixes_and_stop_semantics():
    """Rows whose prefix runs past the prefill keep their prefix tokens;
    rows that never stop get [STOP] at the last written position; stopped
    rows emit [PAD] — token for token with coati_tpu."""
    jparams, jcfg, model, tcfg, tok = _small(seed=5)
    rows = [tok.tokenize_text(p, pad=False) for p in ("[SMILES]C", "[SMILES]CC(", "[SMILES]N")]
    b, total = len(rows), 12
    pre = np.zeros((b, total), np.int32)
    for i, r in enumerate(rows):
        pre[i, : len(r)] = r
    lens = np.asarray([len(r) for r in rows], np.int32)
    common = dict(
        prefill_len=int(lens.min()), total_len=total, stop_token=tok.stop_token,
        pad_token=tok.pad_token, k=1, inv_temp=1.0,
    )
    ref = jsm.generate_tokens(
        jparams.xformer, jcfg.xformer_config, jax.random.PRNGKey(0), jnp.asarray(pre),
        jnp.asarray(lens), approx_top_k=False, **common,
    )
    mine = tsm.generate_tokens(
        model.xformer, tcfg.xformer_config, None, torch.tensor(pre), torch.tensor(lens), **common
    )
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mine.numpy()[1, : len(rows[1])], rows[1])
    for row in mine.numpy():  # every row ends with exactly one [STOP], then [PAD]
        stops = np.nonzero(row == tok.stop_token)[0]
        assert len(stops) == 1 and (row[stops[0] + 1 :] == tok.pad_token).all()


@pytest.mark.parametrize("noise_scale", [0.0, 0.3])
def test_round_trip_api_greedy_token_exact(noise_scale):
    """smiles_to_2d_batch and hclip_to_2d_batch against coati_tpu, greedy,
    with the same seed: the numpy host noise is shared, so noisy decodes
    inject the same embedding in both."""
    jparams, jcfg, model, tcfg, tok = _small(seed=6)
    toks = _smiles_tokens(tok, SMALL_SMILES)
    jm, tm = JaxCOATI(jparams, jcfg, seed=5), COATI(model, tcfg, seed=5)
    jsmiles, jh = jm.smiles_to_2d_batch(
        toks, tok, k=1, noise_scale=noise_scale, return_embeddings=True
    )
    smiles, h = tm.smiles_to_2d_batch(
        toks, tok, k=1, noise_scale=noise_scale, return_embeddings=True
    )
    _close(h, jh)
    assert smiles == jsmiles
    hclip = np.asarray(jh)
    jsmiles2, jtoks = jm.hclip_to_2d_batch(
        hclip, tok, k=1, noise_scale=noise_scale, keep_special=True, return_tokens=True
    )
    smiles2, toks2 = tm.hclip_to_2d_batch(
        hclip, tok, k=1, noise_scale=noise_scale, keep_special=True, return_tokens=True
    )
    assert (smiles2, toks2) == (jsmiles2, jtoks)
    assert tm.hclip_to_2d(hclip[0], tok, k=1) == jm.hclip_to_2d(hclip[0], tok, k=1)


def test_documents_load_in_both_formats(tmp_path):
    """A coati_tpu-format (nested) and a reference-format (flat) document of
    the same weights load into the same model, on the CPU when asked."""
    jparams, jcfg, model, tcfg, tok = _small(seed=7)
    kwargs = {f: getattr(tcfg, f) for f in (
        "n_layer_e3gnn", "n_layer_xformer", "n_hidden_xformer", "n_hidden_e3nn",
        "n_embd_common", "n_head", "n_seq", "n_tok", "norm_clips", "token_mlp",
    )}
    toks = _smiles_tokens(tok, SMALL_SMILES)
    want = tco.encode_tokens(model, tcfg, torch.tensor(toks, dtype=torch.long), tok.stop_token)
    train_args = {"tokenizer_vocab": "mar_verysimple"}
    for name, state in (
        ("nested", params_to_state(jparams)),
        ("flat", {f"module.{k}": v for k, v in export_coati(jparams, jcfg).items()}),
    ):
        path = tmp_path / f"{name}.pkl"
        path.write_bytes(serialize_model(train_args, {}, state, kwargs))
        loaded, ltok = load_e3gnn_smiles_clip_e2e(str(path), device="cpu")
        assert ltok.n_token == tok.n_token and loaded.device.type == "cpu"
        _close(loaded.encode_tokens(toks, ltok), want.numpy(), atol=0, rtol=0)
        with pytest.raises(NotImplementedError, match="EGNN"):
            loaded.encode_points(None, None)


# ------------------------------------------------------- the trained model


@pytest.fixture(scope="module")
def trained_pair():
    jmodel, jtok = jax_load(str(DOC))
    jmodel = JaxCOATI(jmodel.params, jmodel.config.replace(precision="highest"))
    tmodel, ttok = load_e3gnn_smiles_clip_e2e(str(DOC), device="cpu")
    assert ttok.keys == jtok.keys and ttok.n_seq == jtok.n_seq == 250
    return jmodel, jtok, tmodel, ttok


def test_trained_document_embeddings_and_greedy_decodes(trained_pair):
    """docs/eval_model_r5.pkl (16x256 grande, 'mar' vocab) in both
    packages, fp32: 8 SMILES encoded at T = 64 agree to the shared
    tolerance, and greedy round trips at total_len = 64 agree token for
    token."""
    jmodel, jtok, tmodel, ttok = trained_pair
    toks = _smiles_tokens(ttok, SMILES, width=64)
    jsmiles, jh = jmodel.smiles_to_2d_batch(
        toks, jtok, k=1, keep_special=True, return_embeddings=True, total_len=64
    )
    smiles, h = tmodel.smiles_to_2d_batch(
        toks, ttok, k=1, keep_special=True, return_embeddings=True, total_len=64
    )
    _close(h, jh)
    assert smiles == jsmiles
