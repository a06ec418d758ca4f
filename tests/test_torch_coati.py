"""coati_tpu_torch composite model, sampler, API and IO against coati_tpu
on the CPU: weights carried across both ways, encode and the clip-token
MLP, greedy generation token for token, the embed -> decode round trip
with shared host noise, prefix completion, the likelihood methods, the
fingerprint heads, the losses and the training forward with the gradient of
every parameter, and the trained grande document docs/eval_model_r5.pkl on
both of its paths (SMILES and 3D point clouds).

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

from coati_tpu_torch.data import load_points_fixture
from coati_tpu_torch.generative.purifications import embed_smiles_batch
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import sampler as tsm
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.convert import model_from_state, state_from_coati_tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

from tests import torch_port_helpers as hp

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


def _points(seed=0):
    """Four small ragged point clouds: (atoms (4, 9) int, coords (4, 9, 3))."""
    rng = np.random.default_rng(seed)
    atoms = rng.choice([1, 6, 7, 8], size=(4, 9)) * (np.arange(9)[None] < [[9], [6], [3], [1]])
    return atoms.astype(np.int32), rng.normal(scale=2.0, size=(4, 9, 3)).astype(np.float32)


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
        atoms, coords = _points()
        _close(
            loaded.encode_points(atoms, coords),
            jco.encode_points(jparams, jcfg, jnp.asarray(atoms), jnp.asarray(coords)),
        )


@pytest.mark.parametrize("noise_scale", [0.0, 0.3])
def test_points_api_greedy_token_exact(noise_scale):
    """encode_points, points_to_2d_batch and points_to_2d against coati_tpu
    on a small model, greedy, with the same seed (shared numpy host noise)."""
    jparams, jcfg, model, tcfg, tok = _small(seed=8)
    atoms, coords = _points(1)
    jm, tm = JaxCOATI(jparams, jcfg, seed=5), COATI(model, tcfg, seed=5)
    _close(tm.encode_points(atoms, coords), jm.encode_points(atoms, coords))
    kw = dict(k=1, noise_scale=noise_scale, keep_special=True)
    assert tm.points_to_2d_batch(atoms, coords, tok, **kw) == jm.points_to_2d_batch(
        atoms, coords, tok, **kw
    )
    assert tm.points_to_2d(atoms[1], coords[1], tok, k=1) == jm.points_to_2d(
        atoms[1], coords[1], tok, k=1
    )


def test_prefix_completion_greedy_token_exact_with_unequal_prefixes():
    """complete_batch, prefix_generate_batch and smiles_to_graph_batch against
    coati_tpu, greedy: prefixes of unequal length, so some rows keep prefix
    tokens past the prefill."""
    jparams, jcfg, model, tcfg, tok = _small(seed=9)
    jm, tm = JaxCOATI(jparams, jcfg, seed=1), COATI(model, tcfg, seed=1)
    prefixes = ["[SMILES]C", "[SMILES]CC(N", "[SMILES]", "[SMILES]CCOC(C)"]
    for kw in (dict(), dict(keep_special=True, de_fim=False)):
        assert tm.complete_batch(prefixes, tok, k=1, **kw) == jm.complete_batch(
            prefixes, tok, k=1, **kw
        )
    parts = ["C", "CC(N", "CCOC"]
    assert tm.prefix_generate_batch(parts, tok, k=1, keep_special=True) == (
        jm.prefix_generate_batch(parts, tok, k=1, keep_special=True)
    )
    assert tm.prefix_generate_batch(parts, tok, k=1) == jm.prefix_generate_batch(parts, tok, k=1)
    assert tm.smiles_to_graph_batch(["CCO", "C"], tok, k=1) == jm.smiles_to_graph_batch(
        ["CCO", "C"], tok, k=1
    )
    assert tm.smiles_to_graph("CCO", tok, k=1) == jm.smiles_to_graph("CCO", tok, k=1)


def test_likelihood_methods_match_jax(monkeypatch):
    """tokens_likelihood, hclip_and_tokens_to_likelihood and
    batch_smiles_to_s2s_likelihood against coati_tpu at rtol 1e-4; an
    untokenizable row is masked out in both; chunking the batch changes
    nothing."""
    from coati_tpu_torch.models import api as tapi

    jparams, jcfg, model, tcfg, tok = _small(seed=10)
    jm, tm = JaxCOATI(jparams, jcfg), COATI(model, tcfg)
    smiles = ["CCO", "C?C", "CNC(C)O", "CC", "CCCN"]
    jnll, jmask = jm.batch_smiles_to_s2s_likelihood(smiles, tok)
    nll, mask = tm.batch_smiles_to_s2s_likelihood(smiles, tok)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.tolist() == [True, False, True, True, True] and nll.shape == (4,)
    _close(nll, jnll, atol=1e-5, rtol=1e-4)
    monkeypatch.setattr(tapi, "LIKELIHOOD_CHUNK", 3)
    chunked, _ = tm.batch_smiles_to_s2s_likelihood(smiles, tok)
    _close(chunked, nll.numpy(), atol=1e-6, rtol=1e-6)
    empty, none = tm.batch_smiles_to_s2s_likelihood(["C?C"], tok)
    assert empty.shape == (0,) and none.tolist() == [False]

    hclip = np.random.default_rng(11).normal(size=(tcfg.embed_dim,)).astype(np.float32)
    for smi in ("CCO", "CNC(C)O"):
        _close(
            tm.hclip_and_tokens_to_likelihood(hclip, smi, tok),
            jm.hclip_and_tokens_to_likelihood(hclip, smi, tok),
            atol=1e-5, rtol=1e-4,
        )
    _close(
        tm.hclip_and_tokens_to_likelihood(torch.tensor(hclip), "CC", tok),
        jm.hclip_and_tokens_to_likelihood(hclip, "CC", tok),
        atol=1e-5, rtol=1e-4,
    )


def test_fingerprint_heads_match_jax():
    """get_fp_pred_v2 and get_fp_pred on a tiny model with an fp_map."""
    fp_map = (("morgan", 24), ("maccs", 7))
    jparams, jcfg, model, tcfg, tok = _small(seed=12, fp_map=fp_map)
    jm, tm = JaxCOATI(jparams, jcfg), COATI(model, tcfg)
    toks = _smiles_tokens(tok, SMALL_SMILES)
    atoms, coords = _points(2)
    for name, bits in fp_map:
        mine = tm.get_fp_pred_v2(toks, tok, name)
        assert mine.shape == (4, bits)
        _close(mine, jm.get_fp_pred_v2(toks, tok, name))
        _close(tm.get_fp_pred(toks, tok, atoms, coords, name),
               jm.get_fp_pred(toks, tok, atoms, coords, name))
    h = tm.encode_tokens(toks, tok)
    preds = tco.fp_predictions(model, tcfg, tco.clip_to_special_token(model, h))
    assert sorted(preds) == ["maccs", "morgan"]
    assert tco.fp_predictions(*_small(seed=12)[2:4], h) == {}


def test_embed_smiles_batch_matches_jax():
    from coati_tpu.generative.purifications import embed_smiles_batch as jax_embed

    jparams, jcfg, model, tcfg, tok = _small(seed=13)
    mine = embed_smiles_batch(SMALL_SMILES, COATI(model, tcfg), tok)
    assert isinstance(mine, np.ndarray) and mine.dtype == np.float32
    _close(mine, jax_embed(SMALL_SMILES, JaxCOATI(jparams, jcfg), tok))


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


# rows of the fixture with at most 21 atoms, so that N = 24 holds them
FIXTURE_ROWS = [849, 400, 648, 330, 482, 532, 3, 810]


def _fixture_points():
    smiles, atoms, coords = load_points_fixture()
    assert atoms.shape == (1024, 128) and coords.shape == (1024, 128, 3)
    assert (atoms[FIXTURE_ROWS, 24:] == 0).all()
    return ([smiles[i] for i in FIXTURE_ROWS], atoms[FIXTURE_ROWS, :24].astype(np.int32),
            coords[FIXTURE_ROWS, :24])


def test_points_fixture_is_packed_and_matches_its_smiles():
    """Atoms come before the padding in every row, padding has zero
    coordinates, and each row has the heavy atoms of its SMILES."""
    smiles, atoms, coords = load_points_fixture()
    live = atoms > 0
    assert (live[:, :-1] >= live[:, 1:]).all() and live[:, 0].all()
    assert not coords[~live].any() and np.isfinite(coords).all()
    assert len(smiles) == len(set(smiles)) == 1024
    for i in FIXTURE_ROWS:
        assert (atoms[i] == 35).sum() == smiles[i].count("Br")
        assert (atoms[i] == 16).sum() == smiles[i].count("S") + smiles[i].count("s")


def test_trained_document_point_embeddings_and_greedy_decodes(trained_pair):
    """The point-cloud path of docs/eval_model_r5.pkl (EGNN 5 x 256, cutoff
    5 A) in both packages, fp32, on 8 molecules of the fixture: encode_points
    agrees to the shared tolerance, and greedy points_to_2d_batch decodes
    agree token for token. The decode runs at n_seq 64 in both, which cuts
    the steps, not the model."""
    jmodel, jtok, tmodel, ttok = trained_pair
    smiles, atoms, coords = _fixture_points()
    jh = jmodel.encode_points(atoms, coords)
    h = tmodel.encode_points(atoms, coords)
    assert h.shape == (8, 256)
    _close(h, jh)
    # a CLIP model: each point embedding lies nearest its own SMILES embedding
    hs = tmodel.encode_tokens(_smiles_tokens(ttok, smiles, width=64), ttok)
    sims = torch.nn.functional.cosine_similarity(h[:, None], hs[None], dim=-1)
    assert sims.argmax(dim=1).tolist() == list(range(8))

    jshort = JaxCOATI(jmodel.params, jmodel.config.replace(n_seq=64))
    tshort = COATI(tmodel.params, tmodel.config.replace(n_seq=64))
    kw = dict(k=1, keep_special=True)
    decoded = tshort.points_to_2d_batch(atoms, coords, ttok, **kw)
    assert decoded == jshort.points_to_2d_batch(atoms, coords, jtok, **kw)
    assert all(s.startswith("[CLIP][UNK][SMILES]") for s in decoded)


def test_trained_document_likelihoods_and_prefix_completion(trained_pair):
    """The rest of the inference API on the trained document, fp32: the
    likelihood methods within rtol 1e-4, and greedy prefix completion token
    for token with prefixes of unequal length (at n_seq 64)."""
    jmodel, jtok, tmodel, ttok = trained_pair
    jnll, jmask = jmodel.batch_smiles_to_s2s_likelihood(SMILES, jtok)
    nll, mask = tmodel.batch_smiles_to_s2s_likelihood(SMILES, ttok)
    assert mask.all() and jmask.all()
    _close(nll, jnll, atol=1e-4, rtol=1e-4)  # sums of ~30 terms of size ~1
    hclip = np.asarray(jmodel.encode_tokens(_smiles_tokens(jtok, SMILES[:2], width=64), jtok))
    for vec, smi in zip(hclip, SMILES[:2]):
        _close(
            tmodel.hclip_and_tokens_to_likelihood(vec, smi, ttok),
            jmodel.hclip_and_tokens_to_likelihood(vec, smi, jtok),
            atol=1e-4, rtol=1e-4,
        )
    jshort = JaxCOATI(jmodel.params, jmodel.config.replace(n_seq=64))
    tshort = COATI(tmodel.params, tmodel.config.replace(n_seq=64))
    prefixes = ["[SMILES]CC(=O)O", "[SMILES]c1cc", "[SMILES]", "[SMILES]CN1C=NC2=C1C(=O)"]
    assert tshort.complete_batch(prefixes, ttok, k=1) == jshort.complete_batch(prefixes, jtok, k=1)
    parts = ["CC(C)Cc1ccc", "N"]
    assert tshort.prefix_generate_batch(parts, ttok, k=1, keep_special=True) == (
        jshort.prefix_generate_batch(parts, jtok, k=1, keep_special=True)
    )


def test_trained_document_packed_prefill_equals_auto(trained_pair):
    """prefill_kernel="packed" on the CPU: the same embeddings and greedy
    decodes as "auto" (both wrappers run one plain version there)."""
    _, _, tmodel, ttok = trained_pair
    packed = COATI(tmodel.params, tmodel.config.replace(prefill_kernel="packed"))
    toks = _smiles_tokens(ttok, SMILES[:4], width=64)
    smiles, h = tmodel.smiles_to_2d_batch(toks, ttok, k=1, return_embeddings=True, total_len=64)
    psmiles, ph = packed.smiles_to_2d_batch(toks, ttok, k=1, return_embeddings=True, total_len=64)
    assert psmiles == smiles
    _close(ph, h, atol=0, rtol=0)
    with pytest.raises(ValueError, match="T <= 128"):
        packed.encode_tokens(_smiles_tokens(ttok, SMILES[:2], width=250), ttok)


# ------------------------------------------------ losses and training forward

TRAIN_SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN(CC)CC", "OCC1OC(O)C(O)C(O)C1O", "CC(C)C"]


def test_losses_match_jax_values_and_gradients():
    """clip_loss with bad rows, ar_loss_fn with -1 labels, and the
    all-masked batch, whose loss is zero with a zero gradient."""
    rng = np.random.default_rng(40)
    sf, cf = (rng.normal(size=(6, 32)).astype(np.float32) for _ in range(2))
    bad = np.array([False, True, False, False, True, False])
    ts, tc = (torch.tensor(x, requires_grad=True) for x in (sf, cf))
    mine = tco.clip_loss(ts, tc, torch.tensor(bad))
    ref, (ds, dc) = jax.value_and_grad(
        lambda a, b: jco.clip_loss(a, b, jnp.asarray(bad), jax.lax.Precision.HIGHEST),
        argnums=(0, 1))(jnp.asarray(sf), jnp.asarray(cf))
    _close(mine.detach(), ref)
    mine.backward()
    _close(ts.grad, ds)
    _close(tc.grad, dc)
    assert mine.dtype == torch.float32
    assert tco.clip_loss(ts.bfloat16(), tc.bfloat16(), torch.tensor(bad)).dtype == torch.float32

    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 7))
    labels[0, 3:] = -1
    labels[2] = -1
    tl = torch.tensor(logits, requires_grad=True)
    mine = tco.ar_loss_fn(tl, torch.tensor(labels))
    ref, dl = jax.value_and_grad(lambda x: jco.ar_loss_fn(x, jnp.asarray(labels)))(
        jnp.asarray(logits))
    _close(mine.detach(), ref)
    mine.backward()
    _close(tl.grad, dl)
    assert not tl.grad[2].any()
    _close(tco.cross_entropy_ignore(torch.tensor(logits[0]), torch.tensor(labels[0]) * 0 + 5, 5),
           jco.cross_entropy_ignore(jnp.asarray(logits[0]), jnp.asarray(labels[0]) * 0 + 5, 5))

    tl = torch.tensor(logits, requires_grad=True)
    masked = tco.ar_loss_fn(tl, torch.full((3, 7), -1))
    assert float(masked.detach()) == 0.0 == float(jco.ar_loss_fn(jnp.asarray(logits), jnp.full((3, 7), -1)))
    masked.backward()
    assert not tl.grad.any()


def test_fp_loss_matches_jax():
    rng = np.random.default_rng(41)
    preds = {"morgan": rng.normal(size=(4, 24)).astype(np.float32),
             "maccs": rng.normal(size=(4, 7)).astype(np.float32)}
    targets = {k: rng.integers(0, 2, size=v.shape) for k, v in preds.items()}
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in preds.items()}
    mine = tco.fp_loss_fn(tp, {k: torch.tensor(v) for k, v in targets.items()})
    ref, grads = jax.value_and_grad(
        lambda p: jco.fp_loss_fn(p, {k: jnp.asarray(v) for k, v in targets.items()}))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    _close(mine.detach(), ref)
    mine.backward()
    for k in preds:
        _close(tp[k].grad, grads[k])
    assert float(tco.fp_loss_fn({}, {})) == 0.0 == float(jco.fp_loss_fn({}, {}))


def _shared_pick(key, rows, p):
    """The clip-token choice coati_tpu's forward draws from `key`."""
    return np.asarray(jax.random.uniform(key, (rows, 1)) > p)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_training_forward_matches_jax_outputs_loss_and_every_gradient(remat):
    """coati.forward with the same clip-token choice on both sides: the four
    outputs, the total loss ar + clip * log2(n_tok), and the gradient of
    every parameter, also with both trunks rematerialized. One row is all
    padding (a failed row of the transform)."""
    tok = hp.tokenizer(32)
    jparams, jcfg, model, tcfg = hp.model_pair(seed=42, n_layer_e3gnn=2, remat=remat,
                                               egnn_remat=remat)
    batch = hp.batch_arrays(tok, TRAIN_SMILES, seed=43)
    batch["tokens"][3] = 0
    batch["y_next"][3] = -1
    key = jax.random.PRNGKey(44)
    pick = _shared_pick(key, len(TRAIN_SMILES), 0.5)
    assert pick.any() and not pick.all()
    unit = float(np.log2(tok.n_token))
    jb = hp.jax_batch(batch)

    def jloss(params):
        he, hs, logits, bad = jco.forward(params, jcfg, key, jb["raw_tokens"], jb["tokens"],
                                          jb["atoms"], jb["coords"], tok.stop_token,
                                          tok.unk_token, 0.5)
        ar, cl = jco.ar_loss_fn(logits, jb["y_next"]), jco.clip_loss(hs, he, bad)
        return ar + cl * unit, (he, hs, logits, bad, ar, cl)

    (jtotal, (jhe, jhs, jlogits, jbad, jar, jcl)), jgrads = jax.value_and_grad(
        jloss, has_aux=True)(jparams)
    tb = hp.torch_batch(batch)
    he, hs, logits, bad = tco.forward(model, tcfg, None, tb["raw_tokens"], tb["tokens"],
                                      tb["atoms"], tb["coords"], tok.stop_token, tok.unk_token,
                                      0.5, pick_point=torch.tensor(pick))
    _close(he.detach(), jhe)
    _close(hs.detach(), jhs)
    _close(logits.detach(), jlogits, atol=1e-4)  # 32-wide sums into logits of order 10
    assert bad.tolist() == np.asarray(jbad).tolist() == [False, False, False, True, False, False]
    ar, cl = tco.ar_loss_fn(logits, tb["y_next"]), tco.clip_loss(hs, he, bad)
    total = ar + cl * unit
    np.testing.assert_allclose(float(ar.detach()), float(jar), rtol=1e-5)
    np.testing.assert_allclose(float(cl.detach()), float(jcl), rtol=1e-5)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    total.backward()
    compared = hp.assert_gradients_match(model.named_parameters(), jgrads, atol=1e-4, rtol=1e-3,
                                         unused=(".coord_mlp.",))
    assert compared == len(list(model.parameters())) - 2 * 3  # all but two layers' coord MLPs


def test_training_forward_draws_the_choice_from_the_generator():
    """Without a given mask the choice comes from the torch.Generator: the
    same seed gives the same logits, another seed other ones, p 0 and 1 take
    the point token and the SMILES token for every row."""
    tok = hp.tokenizer(32)
    _, _, model, tcfg = hp.model_pair(seed=45)
    tb = hp.torch_batch(hp.batch_arrays(tok, TRAIN_SMILES, seed=46))

    def logits(seed, p, pick=None):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tco.forward(model, tcfg, gen, tb["raw_tokens"], tb["tokens"], tb["atoms"],
                               tb["coords"], tok.stop_token, tok.unk_token, p, pick_point=pick)[2]

    assert torch.equal(logits(0, 0.5), logits(0, 0.5))
    assert any(not torch.equal(logits(0, 0.5), logits(seed, 0.5)) for seed in (1, 2, 3))
    ones = torch.ones(len(TRAIN_SMILES), dtype=torch.bool)
    assert torch.equal(logits(0, 0.0), logits(None, 0.5, ones))
    assert torch.equal(logits(0, 1.0), logits(None, 0.5, ~ones))
    assert not torch.equal(logits(0, 0.0), logits(0, 1.0))


def test_forward_fp_matches_jax():
    tok = hp.tokenizer(32)
    fp_map = (("morgan", 24), ("maccs", 7))
    jparams, jcfg, model, tcfg = hp.model_pair(seed=47, fp_map=fp_map)
    batch = hp.batch_arrays(tok, TRAIN_SMILES, seed=48)
    key = jax.random.PRNGKey(49)
    pick = _shared_pick(key, len(TRAIN_SMILES), 0.4)
    jb, tb = hp.jax_batch(batch), hp.torch_batch(batch)
    ref = jco.forward_fp(jparams, jcfg, key, jb["raw_tokens"], jb["tokens"], jb["atoms"],
                         jb["coords"], tok.stop_token, tok.unk_token)
    with torch.no_grad():
        mine = tco.forward_fp(model, tcfg, None, tb["raw_tokens"], tb["tokens"], tb["atoms"],
                              tb["coords"], tok.stop_token, tok.unk_token,
                              pick_point=torch.tensor(pick))
    for x, r in zip(mine[:2], ref[:2]):
        _close(x, r)
    _close(mine[2], ref[2], atol=1e-4)
    assert mine[3].tolist() == np.asarray(ref[3]).tolist()
    assert sorted(mine[4]) == sorted(ref[4]) == ["maccs", "morgan"]
    for name in mine[4]:
        _close(mine[4][name], ref[4][name])


def test_fresh_model_initialisation_has_the_bounds_coati_tpu_imitates():
    """A fresh CoatiModel takes PyTorch's defaults: Linear weights and biases
    uniform within 1/sqrt(fan_in), embeddings standard normal, LayerNorm one
    and zero. coati_tpu's init_coati draws the same distributions
    (ops/layers.py torch_linear_init, torch_embedding_init), so the bounds
    and moments agree; the values cannot (two generators)."""
    from coati_tpu_torch.training.train import fresh_model

    jparams, _, _, tcfg = hp.model_pair(seed=50, n_hidden_xformer=64, n_embd_common=64, n_head=4)
    model = fresh_model(tcfg, torch.device("cpu"), seed=0)
    again = fresh_model(tcfg, torch.device("cpu"), seed=0)
    other = fresh_model(tcfg, torch.device("cpu"), seed=1)
    ref = {k: v.numpy() for k, v in state_from_coati_tpu(params_to_state(jparams)).items()}
    for (name, p), q, r in zip(model.named_parameters(), again.parameters(), other.parameters()):
        assert torch.equal(p, q), name
        x, jx = p.detach().numpy(), ref[name]
        assert x.shape == jx.shape
        if name.endswith("tok_emb.weight"):
            assert abs(x.std() - 1) < 0.05 and abs(jx.std() - 1) < 0.05 and abs(x.mean()) < 0.05
        elif np.ptp(jx) == 0:  # LayerNorm scales and biases
            assert np.array_equal(x, jx), name
        else:
            assert not torch.equal(p, r), name
            fan_in = p.shape[1] if p.dim() == 2 else None
            if fan_in is None:  # a bias: the bound of its layer's weight
                weight = dict(model.named_parameters())[name[: -len("bias")] + "weight"]
                fan_in = weight.shape[1]
            bound = 1 / np.sqrt(fan_in)
            assert np.abs(x).max() <= bound and np.abs(jx).max() <= bound + 1e-7, name
            if x.size >= 1024:  # a uniform's standard deviation is bound / sqrt(3)
                assert abs(x.std() * np.sqrt(3) / bound - 1) < 0.1, name
                assert abs(jx.std() * np.sqrt(3) / bound - 1) < 0.1, name
