"""coati_tpu_torch's DUE regression against coati_tpu's on the CPU: the
FCResNet with its spectral scaling and power iteration, the RBF kernel, the
SVGP predictive and KL on the same parameters; one and three train_due
steps at dropout_rate 0 from the same parameters with the same minibatch
indices; predict, remove_spectral_norm, save / load, continuation,
basic_due; coati_tpu's saved models carried across; and load_torch_due on a
state dict and on a full pickled DKL module written here, against
coati_tpu's importer on the same file.

Tolerance atol 3e-5, rtol 1e-4: the port's GP algebra runs in float64,
coati_tpu's in float32 at precision "highest"."""

import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from coati_tpu.regression import due as jd
from coati_tpu.regression import due_import as jdi

from coati_tpu_torch.models.convert import due_from_coati_tpu
from coati_tpu_torch.regression import due as td
from coati_tpu_torch.regression import due_import as tdi
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

D_IN = 24
SMALL = dict(input_dim=D_IN, features=32, depth=2, n_inducing=10, dropout_rate=0.0)


def _data(n=160, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, D_IN)).astype(np.float32)
    y = (2.0 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    return x, y


def _jax_model(steps=0, seed=0, **kw):
    x, y = _data()
    cfg = jd.DueConfig(**{**SMALL, **kw})
    return jd.train_due(x, y, config=cfg, steps=steps, batch_size=32, seed=seed, verbose=False)


def _carry(jmodel):
    """coati_tpu's DueModel as the port's, on the CPU."""
    return due_from_coati_tpu(jax.tree_util.tree_map(np.asarray, jmodel.params),
                              jmodel.config.__dict__, device="cpu")


def _assert_same_model(mine, ref, atol=hp.ATOL, rtol=hp.RTOL):
    want = _carry(ref).params.state_dict()
    got = mine.params.state_dict()
    assert got.keys() == want.keys()
    for name in got:
        hp.close(got[name], want[name].numpy(), atol=atol, rtol=rtol)


# ------------------------------------------------------------ the modules


def test_fc_resnet_forward_and_power_iteration_equal_coati_tpu_s():
    jmodel = _jax_model(seed=1)
    model = _carry(jmodel)
    x = _data(seed=2)[0][:17]
    for first, residuals in ((True, True), (False, True), (False, False)):
        jf, jnet = jd.fc_resnet_apply(jmodel.params.net, jnp.asarray(x), 0.95,
                                      spectral_first=first, spectral_residuals=residuals)
        with torch.no_grad():
            f, (u_first, u_res) = td.fc_resnet_apply(model.params.net, torch.as_tensor(x), 0.95,
                                                     spectral_first=first,
                                                     spectral_residuals=residuals)
        hp.close(f, np.asarray(jf))
        hp.close(u_first, np.asarray(jnet.u_first))
        hp.close(u_res, np.asarray(jnet.u_res))


def test_dropout_draws_from_the_generator_only():
    model = _carry(_jax_model(seed=1))
    x = torch.as_tensor(_data(seed=2)[0][:9])
    with torch.no_grad():
        plain, _ = td.fc_resnet_apply(model.params.net, x, dropout_rate=0.5)
        masked = [td.fc_resnet_apply(model.params.net, x, dropout_rate=0.5,
                                     generator=torch.Generator().manual_seed(3))[0]
                  for _ in range(2)]
    assert torch.equal(masked[0], masked[1]) and not torch.equal(masked[0], plain)


def test_rbf_predictive_and_kl_equal_coati_tpu_s():
    jmodel = _jax_model(steps=3, seed=4)  # trained a little: var_mean, var_chol move
    model = _carry(jmodel)
    gp, jgp = model.params.gp, jmodel.params.gp
    feats = np.random.default_rng(5).normal(size=(13, 32)).astype(np.float32)
    ls, os_ = float(np.exp(np.asarray(jgp.log_lengthscale))), 1.3
    hp.close(td.rbf_kernel(torch.as_tensor(feats), gp.inducing.detach(), ls, os_),
             np.asarray(jd.rbf_kernel(jnp.asarray(feats), jgp.inducing, ls, os_)))
    for jitter, kxx in ((1e-5, 0.0), (1e-4, 1e-4)):
        with torch.no_grad():
            mean, var = td.svgp_predict_f(gp, torch.as_tensor(feats), jitter, kxx)
        jmean, jvar = jd.svgp_predict_f(jgp, jnp.asarray(feats), jitter, kxx)
        hp.close(mean, np.asarray(jmean))
        hp.close(var, np.asarray(jvar))
        with torch.no_grad():
            hp.close(td.svgp_kl(gp, jitter), np.asarray(jd.svgp_kl(jgp, jitter)))
    assert mean.dtype == var.dtype == torch.float32


def test_a_kzz_that_is_not_positive_definite_gives_nan_as_coati_tpu_s():
    """Every inducing point the same and a negative jitter: Kzz is not
    positive definite. The predictive and the KL are NaN in both packages,
    never finite numbers from a partial factor."""
    jmodel = _jax_model(seed=1)
    gp = _carry(jmodel).params.gp
    with torch.no_grad():
        gp.inducing.copy_(gp.inducing[:1].expand_as(gp.inducing))
    jgp = jmodel.params.gp
    jgp = jgp.replace(inducing=jnp.broadcast_to(jgp.inducing[:1], jgp.inducing.shape))
    feats = np.random.default_rng(5).normal(size=(7, 32)).astype(np.float32)
    jmean, jvar = jd.svgp_predict_f(jgp, jnp.asarray(feats), -0.1)
    assert np.isnan(np.asarray(jmean)).all() and np.isnan(np.asarray(jd.svgp_kl(jgp, -0.1)))
    with torch.no_grad():
        mean, var = td.svgp_predict_f(gp, torch.as_tensor(feats), -0.1)
        kl = td.svgp_kl(gp, -0.1)
    assert torch.isnan(mean).all() and torch.isnan(kl)
    assert torch.isnan(var).all() and np.isnan(np.asarray(jvar)).all()


@pytest.mark.parametrize("steps", [1, 3])
def test_train_due_steps_equal_coati_tpu_s(steps):
    """From the same parameters (dropout_rate 0), `steps` Adam steps on the
    same minibatches leave every parameter and power-iteration vector as
    coati_tpu's do."""
    x, y = _data()
    start = _jax_model(seed=6)
    ref = jd.train_due(x, y, steps=steps, batch_size=32, seed=7, verbose=False,
                       init_model=start)
    mine = td.train_due(x, y, steps=steps, batch_size=32, seed=7, verbose=False,
                        init_model=_carry(start))
    _assert_same_model(mine, ref)


def test_fresh_training_fits_and_continues_like_coati_tpu():
    """train_due from scratch on the CPU fits as coati_tpu's test asks of
    its own (R^2 over 0.5 on the training rows after 400 steps of 128, the
    std larger far from the data); continuing a model for 2 steps equals
    coati_tpu continuing the same model."""
    x, y = _data(n=256)
    config = td.DueConfig(input_dim=D_IN, features=32, depth=2, n_inducing=20)
    model = td.train_due(x, y, config=config, steps=400, batch_size=128, verbose=False,
                         device="cpu")
    mean, std = model.predict(x[:200])
    assert 1 - (mean - y[:200]).var() / y[:200].var() > 0.5
    assert np.isfinite(std).all() and (std > 0).all()
    assert model.predict(np.full((10, D_IN), 25.0, np.float32))[1].mean() > std.mean()
    start = _jax_model(steps=2, seed=8)
    ref = jd.train_due(x, y, steps=2, batch_size=32, seed=9, verbose=False, init_model=start)
    mine = td.train_due(x, y, steps=2, batch_size=32, seed=9, verbose=False,
                        init_model=_carry(start))
    _assert_same_model(mine, ref)


def test_predict_remove_spectral_norm_and_save_load(tmp_path):
    jmodel = _jax_model(steps=3, seed=10)
    model = _carry(jmodel)
    x = _data(n=40, seed=11)[0]
    for got, want in zip(model.predict(x, batch_size=16), jmodel.predict(x)):
        hp.close(got, want)
    stripped, jstripped = model.remove_spectral_norm(), jmodel.remove_spectral_norm()
    assert not stripped.config.spectral_first and model.config.spectral_first
    _assert_same_model(stripped, jstripped)
    for got, want in zip(stripped.predict(x), model.predict(x)):
        hp.close(got, want)
    path = str(tmp_path / "sub" / "due.pt")
    stripped.save(path)
    loaded = td.DueModel.load(path, device="cpu")
    assert loaded.config == stripped.config
    for got, want in zip(loaded(x), stripped.predict(x)):
        np.testing.assert_array_equal(got, want)
    assert td.DueModel.load(path, device="cpu").device.type == "cpu"


def test_coati_tpu_s_saved_model_carries_across(tmp_path):
    jmodel = _jax_model(steps=2, seed=12)
    path = tmp_path / "jax_due.pkl"
    jmodel.save(str(path))
    with open(path, "rb") as f:
        blob = pickle.load(f)
    model = due_from_coati_tpu(blob["params"], blob["config"], device="cpu")
    x = _data(n=20, seed=13)[0]
    for got, want in zip(model.predict(x), jmodel.predict(x)):
        hp.close(got, want)


def test_basic_due_signature_multi_target_and_epochs(tmp_path):
    rng = np.random.default_rng(14)
    dataset = [{"emb": rng.normal(size=D_IN).astype(np.float32), "y": float(i % 7),
                "z": float(i % 3)} for i in range(120)]
    model, (y_test, mean, std) = td.basic_due(
        dataset, x_field="emb", y_field="y", save_as=str(tmp_path / "m.pt"), steps=6,
        batch_size=32, depth=2, test_frac=0.1, remove_spectral_norm=True, device="cpu")
    assert y_test.shape == mean.shape == std.shape == (12,)
    assert not model.config.spectral_first and model.config.depth == 2
    again, _ = td.basic_due(dataset, x_field="emb", y_field="y", load_as=str(tmp_path / "m.pt"),
                            continue_training=True, save_as=str(tmp_path / "m2.pt"), steps=3,
                            batch_size=32, test_frac=0.1, device="cpu")
    assert (tmp_path / "m2.pt").exists() and again.config.spectral_first
    with pytest.raises(ValueError, match="single-output"):
        td.basic_due(dataset, x_field="emb", y_field=["y", "z"], save_as=str(tmp_path / "x.pt"),
                     steps=2, device="cpu")


# ------------------------------------------------------------- the import


def _fake_class(module: str, name: str, base=nn.Module):
    return type(name, (base,), {"__module__": module, "__qualname__": name})


class _FakeModules:
    """Modules named like the due / gpytorch packages, present only while a
    DKL module is pickled: loading it then needs the stub importer."""

    NAMES = ("due", "due.dkl", "due.fc_resnet", "due.layers", "due.layers.spectral_norm_fc",
             "gpytorch", "gpytorch.kernels", "gpytorch.means", "gpytorch.variational")

    def __enter__(self):
        self.mods = {n: types.ModuleType(n) for n in self.NAMES}
        sys.modules.update(self.mods)
        return self

    def cls(self, module, name, base=nn.Module):
        if not hasattr(self.mods[module], name):
            setattr(self.mods[module], name, _fake_class(module, name, base))
        return getattr(self.mods[module], name)

    def __exit__(self, *exc):
        for n in self.NAMES:
            sys.modules.pop(n, None)


def _linear(fake, out_f, in_f, rng, spectral, coeff=0.95):
    layer = fake.cls("due.layers.spectral_norm_fc", "SpectralLinear")()
    if spectral:
        layer.weight_orig = nn.Parameter(torch.as_tensor(
            rng.normal(scale=0.4, size=(out_f, in_f)), dtype=torch.float32))
        for name, n in (("weight_u", out_f), ("weight_v", in_f)):
            v = rng.normal(size=n)
            layer.register_buffer(name, torch.as_tensor(v / np.linalg.norm(v), dtype=torch.float32))
        hook = fake.cls("due.layers.spectral_norm_fc", "SpectralNormFC", object)()
        hook.coeff = coeff
        layer._forward_pre_hooks[0] = hook
    else:
        layer.weight = nn.Parameter(torch.as_tensor(rng.normal(scale=0.2, size=(out_f, in_f)),
                                                    dtype=torch.float32))
    layer.bias = nn.Parameter(torch.as_tensor(rng.normal(scale=0.1, size=out_f),
                                              dtype=torch.float32))
    return layer


def _dkl_module(fake, seed=15, d_in=D_IN, features=16, depth=2, m=8, coeff=0.9):
    """A DKL module tree with the published artifacts' names: the first
    layer without its spectral hook (remove_spectral_norm), the residual
    layers with theirs, a whitened variational GP."""
    rng = np.random.default_rng(seed)
    t = lambda a: nn.Parameter(torch.as_tensor(np.asarray(a), dtype=torch.float32))  # noqa: E731
    fe = fake.cls("due.fc_resnet", "FCResNet")()
    fe.first = _linear(fake, features, d_in, rng, spectral=False)
    fe.residuals = nn.ModuleList(_linear(fake, features, features, rng, True, coeff)
                                 for _ in range(depth))
    dist = fake.cls("gpytorch.variational", "CholeskyVariationalDistribution")()
    dist.variational_mean = t(rng.normal(size=m))
    dist.chol_variational_covar = t(np.tril(rng.normal(scale=0.1, size=(m, m)))
                                    + np.diag(rng.uniform(0.3, 0.8, m)))
    strategy = fake.cls("gpytorch.variational", "VariationalStrategy")()
    strategy.register_buffer("inducing_points", torch.as_tensor(
        rng.normal(size=(m, features)), dtype=torch.float32))
    strategy._variational_distribution = dist
    rbf = fake.cls("gpytorch.kernels", "RBFKernel")()
    rbf.raw_lengthscale = t([[1.2]])
    scale = fake.cls("gpytorch.kernels", "ScaleKernel")()
    scale.base_kernel = rbf
    scale.raw_outputscale = t(0.3)
    mean = fake.cls("gpytorch.means", "ConstantMean")()
    mean.raw_constant = t(0.7)
    gp = fake.cls("due.dkl", "GP")()
    gp.variational_strategy, gp.covar_module, gp.mean_module = strategy, scale, mean
    dkl = fake.cls("due.dkl", "DKL")()
    dkl.feature_extractor, dkl.gp = fe, gp
    return dkl


def test_load_torch_due_equals_coati_tpu_s_on_both_formats(tmp_path):
    """The same artifact, a full pickled module (stub classes on load, the
    coeff from the residual hooks) and its bare state dict (coeff 0.95),
    through both importers: equal predictions and configs."""
    with _FakeModules() as fake:
        dkl = _dkl_module(fake)
        torch.save(dkl, tmp_path / "due_full.pt")
        torch.save(dkl.state_dict(), tmp_path / "due_state.pt")
    assert "due" not in sys.modules and "gpytorch" not in sys.modules
    x = np.random.default_rng(16).normal(size=(25, D_IN)).astype(np.float32)
    for name, coeff in (("due_full.pt", 0.9), ("due_state.pt", 0.95)):
        path = str(tmp_path / name)
        mine, ref = tdi.load_torch_due(path, device="cpu"), jdi.load_torch_due(path)
        assert vars(mine.config) == vars(ref.config)
        assert mine.config.coeff == coeff and not mine.config.spectral_residuals
        for got, want in zip(mine.predict(x), ref.predict(x)):
            hp.close(got, want)
        assert tdi.load_due(path, device="cpu").config == mine.config
    assert not any(n.split(".")[0] in ("due", "gpytorch") for n in sys.modules)


def test_imported_model_is_differentiable_and_load_due_reads_the_port_s_files(tmp_path):
    with _FakeModules() as fake:
        torch.save(_dkl_module(fake, seed=17).state_dict(), tmp_path / "due_state.pt")
    model = tdi.load_torch_due(str(tmp_path / "due_state.pt"), device="cpu")
    v = torch.zeros(D_IN, requires_grad=True)
    mean, _ = model.mean_and_var(v[None])
    (grad,) = torch.autograd.grad(mean[0], v)
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    model.save(str(tmp_path / "port.pkl"))
    again = tdi.load_due(str(tmp_path / "port.pkl"), device="cpu")
    x = np.ones((3, D_IN), np.float32)
    np.testing.assert_array_equal(again.predict(x)[0], model.predict(x)[0])
    with pytest.raises(ValueError, match="no residual layers"):
        tdi.convert_due_state_dict({"feature_extractor.first.weight": np.zeros((2, 2)),
                                    "feature_extractor.first.bias": np.zeros(2)}, device="cpu")
