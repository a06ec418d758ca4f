"""coati_tpu_torch's generative helpers against coati_tpu's on the CPU:
embed_smiles and embed_points on the trained document docs/eval_model_r5.pkl
(fp32, coati_tpu at precision "highest"); the multivariate normal's
log-density, its closed-form fit, and the SGD fit of
estimate_density_batchwise step by step and to the step where it stops;
force_decode_valid_batch on the trained document; and what the purification
helpers catch: an unusable decoded SMILES gives "C" (or V back), and
whatever the decode raises (a wrapper's ValueError, a RuntimeError)
reaches the caller.

Tolerance atol 3e-5, rtol 1e-4 unless a line says why."""

import gzip
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.generative import density as jdn
from coati_tpu.generative import purifications as jpu
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self, is_valid_smiles
from coati_tpu_torch.generative import density as tdn
from coati_tpu_torch.generative import purifications as tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
DOC = ROOT / "docs" / "eval_model_r5.pkl"
CORPUS = ROOT / "corpora" / "chembl_synth_v1.smi.gz"


@pytest.fixture(scope="module")
def trained_pair():
    jmodel, jtok = jax_load(str(DOC))
    jmodel = JaxCOATI(jmodel.params, jmodel.config.replace(precision="highest"))
    tmodel, ttok = load_e3gnn_smiles_clip_e2e(str(DOC), device="cpu")
    return jmodel, jtok, tmodel, ttok


@pytest.fixture(scope="module")
def corpus():
    with gzip.open(CORPUS, "rt") as f:
        return [next(f).strip() for _ in range(32)]


# ------------------------------------------------------------------ embed


def test_embed_smiles_and_embed_points_match_coati_tpu(trained_pair):
    """embed_smiles canonicalizes first (another writing gives the same
    vector); embed_points embeds a conformer with each package's own
    embedder (equal within 1e-6 A) and encodes it with the EGNN."""
    jmodel, jtok, tmodel, ttok = trained_pair
    for s in ("OCC(=O)c1ccccc1", "c1ccccc1C(=O)CO", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"):
        h = tpu.embed_smiles(s, tmodel, ttok)
        assert h.shape == (256,) and h.dtype == np.float32
        hp.close(h, np.asarray(jpu.embed_smiles(s, jmodel, jtok)))
    np.testing.assert_array_equal(tpu.embed_smiles("OCC(=O)c1ccccc1", tmodel, ttok),
                                  tpu.embed_smiles("c1ccccc1C(=O)CO", tmodel, ttok))
    for s in ("CCO", "CC(=O)Nc1ccc(O)cc1"):
        h = tpu.embed_points(s, tmodel)
        assert h.shape == (1, 256) and h.dtype == np.float32
        hp.close(h, np.asarray(jpu.embed_points(s, jmodel)))


# ---------------------------------------------------------------- density


def _random_density(d=12, seed=0):
    rng = np.random.default_rng(seed)
    mean = rng.normal(size=d).astype(np.float32)
    tril = np.tril(rng.normal(scale=0.2, size=(d, d)), k=-1) + np.diag(rng.uniform(0.5, 2.0, d))
    return mean, tril.astype(np.float32), rng.normal(size=(40, d)).astype(np.float32)


def test_mvn_log_prob_sample_and_closed_form_fit_match_coati_tpu():
    mean, tril, x = _random_density()
    mine = tdn.MvnDensity(torch.tensor(mean), torch.tensor(tril))
    ref = jdn.MvnDensity(jnp.asarray(mean), jnp.asarray(tril))
    assert mine.dim == ref.dim == 12
    hp.close(mine.log_prob(torch.tensor(x)), np.asarray(ref.log_prob(jnp.asarray(x))))
    draws = mine.sample(torch.Generator().manual_seed(0), (4000,))
    assert draws.shape == (4000, 12)
    # the draws' mean and covariance: within 5 standard errors of the density's
    np.testing.assert_allclose(draws.mean(0).numpy(), mean, atol=5 * 2.0 / np.sqrt(4000))
    cov = tril.astype(np.float64) @ tril.T
    np.testing.assert_allclose(np.cov(draws.numpy().T), cov, atol=0.25)
    fit = tdn.fit_density_closed_form(x)
    jfit = jdn.fit_density_closed_form(x)
    hp.close(fit.mean, np.asarray(jfit.mean))
    hp.close(fit.scale_tril, np.asarray(jfit.scale_tril))
    from_tensor = tdn.fit_density_closed_form(torch.tensor(x))
    assert torch.equal(from_tensor.scale_tril, fit.scale_tril)


def _embeddings(model, tok, smiles):
    tokens = np.asarray([tok.tokenize_text("[SMILES]" + canonicalize_or_self(s) + "[STOP]",
                                           pad=True) for s in smiles], np.int32)
    return tokens, model.encode_tokens(tokens, tok)


def test_density_sgd_steps_match_coati_tpu(trained_pair, corpus):
    """Four SGD steps (lr 5e-3, mean frozen) from the reference's start on
    16 embeddings of the trained model: each step's entropy (the mean
    negative log-likelihood before it) and the parameters after it. The
    first step moves sq_diag from 0.5 to about 12.7, so the entropy goes
    from about 2,053 to under 0: relative tolerance only."""
    jmodel, jtok, tmodel, ttok = trained_pair
    tokens, embeds = _embeddings(tmodel, ttok, corpus[:16])
    jembeds = jnp.asarray(jmodel.encode_tokens(tokens, jtok))
    hp.close(embeds, np.asarray(jembeds))
    d = 256
    jparams = {"mean": jnp.zeros((d,)), "sq_diag": 0.5 * jnp.ones((d,)),
               "lower": jnp.zeros((d * (d - 1) // 2,))}
    jstate = jdn._SGD.init(jparams)
    params = {"mean": torch.zeros(d), "sq_diag": torch.full((d,), 0.5, requires_grad=True),
              "lower": torch.zeros(d * (d - 1) // 2, requires_grad=True)}
    optimizer = torch.optim.SGD([params["sq_diag"], params["lower"]], lr=tdn.SGD_LR)
    for _ in range(4):
        jparams, jstate, jentropy = jdn._density_step(jparams, jstate, jembeds)
        entropy = tdn._density_step(params, optimizer, embeds)
        assert entropy == pytest.approx(float(jentropy), rel=1e-4)
        for key in ("sq_diag", "lower"):
            hp.close(params[key], np.asarray(jparams[key]))
        assert not params["mean"].any()


def test_estimate_density_batchwise_stops_where_coati_tpu_s_does(trained_pair, corpus):
    """32 SMILES in batches of 8 (one of them a writing the tokenizer
    refuses, skipped), two epochs: the entropy goes about 2075, 189, 69, 76,
    -10.9, so with entropy_limit 0 both fits stop at the fifth batch and
    return the density of the parameters that batch measured; with the
    default limit of -100 and one batch it does not stop."""
    jmodel, jtok, tmodel, ttok = trained_pair
    smiles = corpus[:31] + ["C[Xx]C"]
    mine = tdn.estimate_density_batchwise(smiles, tmodel, ttok, batch_size=8, epochs=2,
                                          entropy_limit=0.0, verbose=False)
    ref = jdn.estimate_density_batchwise(smiles, jmodel, jtok, batch_size=8, epochs=2,
                                         entropy_limit=0.0, verbose=False)
    assert mine is not None and ref is not None
    assert not mine.mean.any() and not mine.scale_tril.requires_grad
    hp.close(mine.scale_tril, np.asarray(ref.scale_tril))
    assert tdn.estimate_density_batchwise(smiles[:8], tmodel, ttok, batch_size=8, epochs=1,
                                          verbose=False) is None


# ----------------------------------------------------------- purification


def test_force_decode_valid_batch_on_the_trained_model(trained_pair):
    """Redecodes of a molecule's own embedding (sampled, top-k 100 at
    inverse temperature 2): the most common valid SMILES, in canonical
    form."""
    _, _, tmodel, ttok = trained_pair
    v = tpu.embed_smiles("CC(=O)O", tmodel, ttok)
    out = tpu.force_decode_valid_batch(v, tmodel, ttok, batch_size=8, max_attempts=2)
    assert out != "C" and is_valid_smiles(out) and out == canonicalize_or_self(out)


class _StubDecoder:
    """A COATI stand-in whose decodes return `regen` or raise `error`."""

    embed_dim = 4

    def __init__(self, regen=(), error=None):
        self.regen, self.error, self.calls = list(regen), error, 0

    def _decode(self, rows):
        self.calls += 1
        if self.error is not None:
            raise self.error
        return (self.regen * rows)[:rows]

    def hclip_to_2d_batch(self, h, tokenizer):
        return self._decode(len(h))

    def hclip_to_2d(self, h, tokenizer):
        self._decode(1)
        return self.regen[(self.calls - 1) % len(self.regen)]

    def encode_tokens(self, tokens, tokenizer):
        return torch.tensor(np.asarray(tokens)[:, :4], dtype=torch.float32)


def test_purifications_catch_unusable_decodes_only():
    """Nothing valid: force_decode_valid(_batch) give "C" after every
    attempt and purify_vector gives V back. A decoded SMILES that is valid
    but does not tokenize (longer than n_seq: the tokenizer's ValueError) is
    left out of the purification. Whatever the decode itself raises reaches
    the caller: a kernel wrapper's ValueError for inputs it cannot launch
    with, a KeyError, a RuntimeError of a kernel that did not build or
    launch; coati_tpu's catch-all would return "C" or V."""
    tok = hp.tokenizer()
    v = np.arange(4, dtype=np.float32)
    invalid = _StubDecoder(["C1CC", "(("])
    assert tpu.force_decode_valid_batch(v, invalid, tok, batch_size=4, max_attempts=3) == "C"
    assert invalid.calls == 3
    assert tpu.force_decode_valid(v, invalid, tok, max_attempts=5) == "C"
    np.testing.assert_array_equal(tpu.purify_vector(v, invalid, tok, n_rep=4), v)
    oversized = "C" * (tok.n_seq + 8)
    assert is_valid_smiles(oversized)
    with pytest.raises(ValueError, match="Oversized"):
        tok.tokenize_text("[SMILES]" + oversized + "[STOP]", pad=True)
    np.testing.assert_array_equal(
        tpu.purify_vector(v, _StubDecoder([oversized]), tok, n_rep=4), v)
    out = tpu.purify_vector(v, _StubDecoder([oversized, "CCO"]), tok, n_rep=4)
    row = tok.tokenize_text("[SMILES]CCO[STOP]", pad=True)[:4]
    np.testing.assert_array_equal(out, np.asarray(row, np.float32))
    errors = (
        ValueError("decode_attention: head dim 40 cannot launch"),
        KeyError("[Xx]"),
        RuntimeError("kernel launch failed"),
    )
    for error in errors:
        for fn in (tpu.force_decode_valid_batch, tpu.force_decode_valid, tpu.purify_vector):
            stub = _StubDecoder(error=error)
            with pytest.raises(type(error)):
                fn(v, stub, tok)
            assert stub.calls == 1
    # coati_tpu's swallows them
    for error in errors:
        assert jpu.force_decode_valid_batch(
            v, _StubDecoder(error=error), tok, max_attempts=1) == "C"


def test_purify_vector_averages_the_valid_decodes():
    """The mean embedding of the valid decodes, each canonicalized first;
    the invalid ones are left out. The most common valid decode wins a
    batch."""
    tok = hp.tokenizer()
    stub = _StubDecoder(["OCC", "((", "CCO", "CCO"])
    out = tpu.purify_vector(np.zeros(4, np.float32), stub, tok, n_rep=4)
    row = tok.tokenize_text("[SMILES]CCO[STOP]", pad=True)[:4]
    np.testing.assert_array_equal(out, np.asarray(row, np.float32))
    assert tpu.force_decode_valid_batch(np.zeros(4), stub, tok, batch_size=4) == "CCO"
    assert tpu.force_decode_valid(np.zeros(4), _StubDecoder(["((", "CCO"]), tok) == "CCO"
