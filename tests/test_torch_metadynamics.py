"""coati_tpu_torch's metadynamics against coati_tpu's on the CPU: the hills
bias, walk_embedding_space trajectories over 10 steps (ascent only, with
hills and noise, over a DUE objective and a combined one), what the walk
must do (ascent never decreases and improves; hills displace the samples),
due_objective's width check, and run_metadynamics with greedy decodes on
the trained document docs/eval_model_r5.pkl (3 steps, decode batch 4).

The DUE objectives carry coati_tpu's model across (models/convert.py), and
the exploration noise is numpy's default_rng(seed) in both packages.
Tolerance atol 3e-5, rtol 1e-4 unless a line says why."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.generative import metadynamics as jmd
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.io import load_e3gnn_smiles_clip_e2e as jax_load
from coati_tpu.regression import due as jd

from coati_tpu_torch.generative import metadynamics as tmd
from coati_tpu_torch.generative.purifications import embed_smiles
from coati_tpu_torch.models.convert import due_from_coati_tpu
from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DOC = Path(__file__).resolve().parents[1] / "docs" / "eval_model_r5.pkl"


def _due_pair(d_in, seed=0, steps=60):
    """coati_tpu's DUE model fitted to a smooth target over d_in-wide
    inputs, and the port's with the same parameters."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, d_in)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] ** 2).astype(np.float32)
    cfg = jd.DueConfig(input_dim=d_in, features=16, depth=2, n_inducing=12, dropout_rate=0.0)
    jmodel = jd.train_due(x, y, config=cfg, steps=steps, batch_size=64, seed=seed, verbose=False)
    model = due_from_coati_tpu(jax.tree_util.tree_map(np.asarray, jmodel.params),
                               jmodel.config.__dict__, device="cpu")
    return jmodel, model


@pytest.fixture(scope="module")
def due16():
    return _due_pair(16)


def test_gaussian_hills_bias_equals_coati_tpu_s():
    rng = np.random.default_rng(1)
    v, centers = rng.normal(size=8).astype(np.float32), rng.normal(size=(5, 8)).astype(np.float32)
    got = tmd.gaussian_hills_bias(torch.as_tensor(v), torch.as_tensor(centers), 0.7, 1.3)
    hp.close(got, np.asarray(jmd.gaussian_hills_bias(jnp.asarray(v), jnp.asarray(centers),
                                                     0.7, 1.3)))
    assert float(tmd.gaussian_hills_bias(torch.zeros(8), torch.zeros(1, 8), 1.0, 1.0)) > \
        float(tmd.gaussian_hills_bias(torch.full((8,), 10.0), torch.zeros(1, 8), 1.0, 1.0))


@pytest.mark.parametrize("hills, noise", [(0.0, 0.0), (0.5, 0.05)])
def test_walk_trajectory_equals_coati_tpu_s(due16, hills, noise):
    """10 steps from the same start: positions and objectives as coati_tpu's,
    ascent only and with hills and noise; a combined objective too."""
    jmodel, model = due16
    v0 = np.random.default_rng(2).normal(scale=0.5, size=16).astype(np.float32)
    cfg = dict(steps=10, step_size=0.05, hill_height=hills, hill_width=1.0, noise_scale=noise,
               seed=3)
    objectives = [
        (jmd.due_objective(jmodel), tmd.due_objective(model)),
        (jmd.combined_objective([jmd.due_objective(jmodel), lambda v: -jnp.sum(v**2)], [2.0, 0.1]),
         tmd.combined_objective([tmd.due_objective(model), lambda v: -(v**2).sum()], [2.0, 0.1])),
    ]
    for jobj, tobj in objectives:
        jpos, jval = jmd.walk_embedding_space(jobj, v0, jmd.MetadynamicsConfig(**cfg))
        pos, val = tmd.walk_embedding_space(tobj, v0, tmd.MetadynamicsConfig(**cfg), device="cpu")
        assert pos.shape == (11, 16) and val.shape == (11,)
        hp.close(pos, jpos)
        hp.close(val, jval)


def test_walk_ascends_and_hills_displace_samples(due16):
    """What scripts/eval_metadynamics.py asks of a walk, here over 40 steps:
    without hills and noise the objective never decreases and improves;
    with hills the walker keeps moving after the plain ascent stalls."""
    _, model = due16
    obj = tmd.due_objective(model)
    v0 = np.random.default_rng(4).normal(scale=0.5, size=16).astype(np.float32)
    base = dict(steps=40, step_size=0.02, noise_scale=0.0, seed=0)
    pos_un, val = tmd.walk_embedding_space(obj, v0, tmd.MetadynamicsConfig(**base, hill_height=0.0),
                                           device="cpu")
    assert np.all(np.diff(val) >= -1e-5) and val[-1] > val[0] + 1e-4
    pos_bi, _ = tmd.walk_embedding_space(
        obj, v0, tmd.MetadynamicsConfig(**base, hill_height=0.5, hill_width=1.0), device="cpu")
    disp = lambda p: np.linalg.norm(np.diff(p, axis=0), axis=1)  # noqa: E731
    assert disp(pos_bi).mean() > disp(pos_un).mean()


def test_due_objective_checks_the_width_and_is_differentiable(due16):
    _, model = due16
    obj = tmd.due_objective(model, scale=2.0)
    with pytest.raises(ValueError, match="expects 16-d embeddings"):
        obj(torch.zeros(8))
    v = torch.zeros(16, requires_grad=True)
    (grad,) = torch.autograd.grad(obj(v), v)
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    hp.close(obj(torch.ones(16)).detach(), 2.0 * model.predict(np.ones((1, 16), np.float32))[0])


def test_run_metadynamics_on_the_trained_document_equals_coati_tpu_s():
    """3 steps, 4 greedy decodes a step, from an embedded corpus molecule,
    over a DUE objective on the 256-wide embeddings: the same molecules
    found with the same scores, the same best, the same history."""
    jmodel_due, model_due = _due_pair(256, seed=5, steps=20)
    jcoati, jtok = jax_load(str(DOC))
    jcoati = JaxCOATI(jcoati.params, jcoati.config.replace(precision="highest"))
    coati, tok = load_e3gnn_smiles_clip_e2e(str(DOC), device="cpu")
    v0 = embed_smiles("CC(=O)Nc1ccc(O)cc1", coati, tok)
    cfg = dict(steps=3, decode_batch=4, k=1, step_size=0.5, noise_scale=0.05, seed=6)
    ref = jmd.run_metadynamics(jcoati, jtok, jmd.due_objective(jmodel_due), v0,
                               jmd.MetadynamicsConfig(**cfg))
    got = tmd.run_metadynamics(coati, tok, tmd.due_objective(model_due), v0,
                               tmd.MetadynamicsConfig(**cfg))
    assert got.smiles == ref.smiles and got.smiles
    hp.close(np.asarray(got.scores), np.asarray(ref.scores))
    hp.close(got.vectors, ref.vectors)
    assert got.best_smiles == ref.best_smiles
    for mine, want in zip(got.history, ref.history):
        assert {k: mine[k] for k in ("step", "n_new", "n_valid", "best_smiles")} == \
            {k: want[k] for k in ("step", "n_new", "n_valid", "best_smiles")}
        hp.close(np.float32(mine["walker_norm"]), np.float32(want["walker_norm"]))
    assert got.top(1)[0][0] == got.best_smiles
