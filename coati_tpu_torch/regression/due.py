"""DUE: uncertainty-aware regression on COATI embeddings.

PyTorch counterpart of coati_tpu/regression/due.py (itself the reference's
DUE/DKL pipeline, coati/models/regression/basic_due.py:14-198, after
arXiv:2102.11409): a Lipschitz-constrained FCResNet feature extractor (soft
spectral normalization, coeff 0.95) feeding a sparse variational GP (RBF
kernel, 60 inducing points initialized by k-means, Gaussian likelihood),
trained end to end on the variational ELBO with Adam 1e-3.

The GP's algebra (Gram matrices, Cholesky factors, solves) runs in float64
and returns float32. A low-precision cross term NaNs the Kzz Cholesky (the
JAX package forces full float32 for it), and float64 keeps every product out
of reach of TF32, whatever `torch.backends.cuda.matmul.allow_tf32` says. The
Cholesky is `cholesky_ex`, which does not wait for the device to check its
result; a failed factor is replaced by NaNs on the device, as JAX gives.

Models save in the port's own format (`torch.save` of the state dict and the
config); `models/convert.due_from_coati_tpu` carries coati_tpu's models
across, `due_import.load_torch_due` the published torch artifacts.

`basic_due` keeps the reference signature and returns
(model, (y_test, mean, std)).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coati_tpu_torch.common.util import makedir, resolve_device

JITTER = 1e-5
PREDICT_BATCH = 4096


# ---------------------------------------------------------- FCResNet


def _uniform_linear(layer: nn.Linear, generator: Optional[torch.Generator]) -> nn.Linear:
    """torch.nn.Linear's default init, U(+-1/sqrt(fan_in)) for weight and
    bias, drawn from `generator`."""
    bound = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-bound, bound, generator=generator)
        layer.bias.uniform_(-bound, bound, generator=generator)
    return layer


class FcResNet(nn.Module):
    """The parameters of coati_tpu's FcResNetParams: `first` (input_dim ->
    features), `res` (depth residual layers), and the power-iteration
    vectors `u_first` (features,) and `u_res` (depth, features) as buffers,
    state that no gradient reaches. Weights in PyTorch's (out, in) layout."""

    def __init__(self, input_dim: int, features: int, depth: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.first = _uniform_linear(nn.Linear(input_dim, features), generator)
        self.res = nn.ModuleList(
            _uniform_linear(nn.Linear(features, features), generator) for _ in range(depth))
        self.register_buffer("u_first", torch.randn(features, generator=generator))
        self.register_buffer("u_res", torch.randn(depth, features, generator=generator))


@torch.no_grad()
def _power_iteration(weight: torch.Tensor, u: torch.Tensor, coeff: float, n_iter: int = 2):
    """(scale, u_new) of soft spectral normalization (DUE): the weight is
    scaled by min(1, coeff / sigma), sigma estimated by power iteration.
    coati_tpu's weight w is this weight transposed, (in, out); u lives in
    the output space."""
    w = weight.T
    for _ in range(n_iter):
        v = w @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u = w.T @ v
        u = u / (torch.linalg.vector_norm(u) + 1e-12)
    sigma = v @ (w @ u)
    return torch.clamp(coeff / (sigma.abs() + 1e-12), max=1.0), u


def _spectral_scale(weight: torch.Tensor, u: torch.Tensor, coeff: float, n_iter: int = 2):
    """-> (weight scaled by min(1, coeff / sigma), u_new). The scale and the
    u update are outside the gradient: a loss reaches the weight through
    the product only."""
    scale, u = _power_iteration(weight, u, coeff, n_iter)
    return weight * scale, u


def fc_resnet_apply(
    p: FcResNet,
    x: torch.Tensor,
    coeff: float = 0.95,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    spectral_first: bool = True,
    spectral_residuals: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """-> (features, (u_first, u_res)), the power-iteration vectors after
    this pass; `p`'s buffers are left as they are.

    spectral_first=False skips the first layer's spectral scaling (the
    reference's remove_spectral_norm strips exactly that hook,
    basic_due.py:179-181); spectral_residuals=False skips the residual
    layers' too (imported torch artifacts, whose eval-time factor is folded
    into their weights, due_import.py). Dropout of `dropout_rate` applies
    to each residual branch when a `generator` is given, its masks drawn
    from it, as coati_tpu drops out when it is given a key."""
    if spectral_first:
        w0, u0 = _spectral_scale(p.first.weight, p.u_first, coeff)
    else:
        w0, u0 = p.first.weight, p.u_first
    h = F.linear(x, w0, p.first.bias)
    new_u = []
    for i, layer in enumerate(p.res):
        if spectral_residuals:
            wi, ui = _spectral_scale(layer.weight, p.u_res[i], coeff)
        else:
            wi, ui = layer.weight, p.u_res[i]
        new_u.append(ui)
        y = torch.relu(F.linear(h, wi, layer.bias))
        if dropout_rate > 0 and generator is not None:
            keep = torch.rand(y.shape, generator=generator, device=y.device) < 1.0 - dropout_rate
            y = torch.where(keep, y / (1.0 - dropout_rate), torch.zeros_like(y))
        h = h + y
    return h, (u0, torch.stack(new_u))


# ------------------------------------------------------------- SVGP


class SvgpParams(nn.Module):
    """The SVGP's parameters: inducing points (M, F), variational mean (M,)
    and raw lower-triangular factor (M, M) (tril applied at use), log
    lengthscale, outputscale and likelihood noise, and the constant prior
    mean (gpytorch's ConstantMean, trained)."""

    def __init__(self, n_inducing: int, features: int):
        super().__init__()
        self.inducing = nn.Parameter(torch.zeros(n_inducing, features))
        self.var_mean = nn.Parameter(torch.zeros(n_inducing))
        self.var_chol = nn.Parameter(torch.eye(n_inducing))
        self.log_lengthscale = nn.Parameter(torch.zeros(()))
        self.log_outputscale = nn.Parameter(torch.zeros(()))
        self.log_noise = nn.Parameter(torch.tensor(math.log(0.5)))
        self.mean_const = nn.Parameter(torch.zeros(()))


class DueParams(nn.Module):
    """Feature extractor `net` and GP `gp`, as coati_tpu's DueParams."""

    def __init__(self, net: FcResNet, gp: SvgpParams):
        super().__init__()
        self.net = net
        self.gp = gp


def rbf_kernel(x1, x2, lengthscale, outputscale):
    """outputscale * exp(-|x1 - x2|^2 / (2 lengthscale^2)), (N1, N2), in
    x1's dtype; the squared distances are taken in float64."""
    a, b = x1.double(), x2.double()
    d2 = (a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :] - 2.0 * (a @ b.T)
    k = outputscale * torch.exp(-0.5 * torch.clamp(d2.to(x1.dtype), min=0.0) / lengthscale**2)
    return k.to(x1.dtype)


def _gp64(p: SvgpParams):
    """(inducing, lengthscale, outputscale) in float64."""
    return p.inducing.double(), p.log_lengthscale.double().exp(), p.log_outputscale.double().exp()


def _kzz_cholesky(p: SvgpParams, jitter: float):
    z, ls, os_ = _gp64(p)
    m = z.shape[0]
    kzz = rbf_kernel(z, z, ls, os_) + jitter * torch.eye(m, dtype=z.dtype, device=z.device)
    # cholesky_ex leaves a partial factor of finite values where Kzz is not
    # positive definite: NaN it, as jnp.linalg.cholesky does, on the device
    lzz, info = torch.linalg.cholesky_ex(kzz)
    return torch.where(info == 0, lzz, torch.full_like(lzz, float("nan")))


def svgp_predict_f(
    p: SvgpParams,
    feats: torch.Tensor,
    jitter: float = JITTER,
    kxx_jitter: float = 0.0,
):
    """q(f) marginal (mean, variance) at the features, float32.

    `jitter` stabilizes the Kzz Cholesky; `kxx_jitter` is added to the prior
    diagonal Kxx (gpytorch's VariationalStrategy adds its jitter_val, 1e-4,
    to both; imported published models set these to match, models trained
    here keep 1e-5 / 0)."""
    z, ls, os_ = _gp64(p)
    f = feats.double()
    lzz = _kzz_cholesky(p, jitter)
    kxz = rbf_kernel(f, z, ls, os_)
    a = torch.cholesky_solve(kxz.T, lzz)  # Kzz^-1 Kzx, (M, N)
    mean = a.T @ p.var_mean.double() + p.mean_const.double()
    s = torch.tril(p.var_chol.double())
    kxx_diag = os_ + kxx_jitter
    var = kxx_diag - (kxz.T * a).sum(0) + ((s.T @ a) ** 2).sum(0)
    return mean.float(), torch.clamp(var, min=1e-10).float()


def svgp_kl(p: SvgpParams, jitter: float = JITTER):
    """KL(q(u) || p(u)) with p(u) = N(0, Kzz), float32."""
    m = p.inducing.shape[0]
    lzz = _kzz_cholesky(p, jitter)
    s = torch.tril(p.var_chol.double())
    trace = (torch.linalg.solve_triangular(lzz, s, upper=False) ** 2).sum()
    linv_m = torch.linalg.solve_triangular(lzz, p.var_mean.double()[:, None], upper=False)
    maha = (linv_m**2).sum()
    logdet_p = 2.0 * torch.log(torch.diagonal(lzz)).sum()
    logdet_q = 2.0 * torch.log(torch.diagonal(s).abs() + 1e-12).sum()
    return (0.5 * (trace + maha - m + logdet_p - logdet_q)).float()


@dataclass
class DueConfig:
    input_dim: int
    features: int = 256
    depth: int = 4
    n_inducing: int = 60
    coeff: float = 0.95
    dropout_rate: float = 0.03
    lr: float = 1e-3
    # False after remove_spectral_norm: the first layer's weight carries
    # its folded spectral scale and is applied as a plain linear map
    spectral_first: bool = True
    # False for models imported from published torch artifacts: the
    # eval-time spectral factor is folded into every residual weight
    spectral_residuals: bool = True
    # Cholesky jitters (see svgp_predict_f); imported gpytorch models use
    # 1e-4 for both, VariationalStrategy's jitter_val
    jitter: float = JITTER
    kxx_jitter: float = 0.0


def empty_params(config: DueConfig, device=None) -> DueParams:
    """DueParams of the config's shapes (values to be loaded)."""
    return DueParams(
        FcResNet(config.input_dim, config.features, config.depth),
        SvgpParams(config.n_inducing, config.features),
    ).to(device)


class DueModel:
    """Trained DUE model: feature extractor + SVGP + Gaussian likelihood,
    on the device its parameters lie on."""

    def __init__(self, params: DueParams, config: DueConfig):
        self.params = params
        self.config = config

    @property
    def device(self) -> torch.device:
        return self.params.gp.inducing.device

    def mean_and_var(self, x: torch.Tensor):
        """Differentiable predictive (mean, variance) of f at x (N, D)."""
        cfg = self.config
        feats, _ = fc_resnet_apply(
            self.params.net, x, cfg.coeff,
            spectral_first=cfg.spectral_first, spectral_residuals=cfg.spectral_residuals,
        )
        return svgp_predict_f(self.params.gp, feats, jitter=cfg.jitter, kxx_jitter=cfg.kxx_jitter)

    @torch.no_grad()
    def predict(self, x: np.ndarray, batch_size: int = PREDICT_BATCH):
        """-> numpy (mean, std) of the predictive distribution of f, without
        observation noise (pred.mean / pred.stddev of the reference,
        basic_due.py:187-189), in batches of `batch_size` rows."""
        means, stds = [], []
        for i in range(0, len(x), batch_size):
            xb = torch.as_tensor(np.asarray(x[i : i + batch_size], np.float32), device=self.device)
            mean, var = self.mean_and_var(xb)
            means.append(mean.cpu().numpy())
            stds.append(var.sqrt().cpu().numpy())
        return np.concatenate(means), np.concatenate(stds)

    def __call__(self, x):
        return self.predict(np.asarray(x))

    def save(self, path: str):
        """torch.save of {"state": the state dict on the CPU, "config": the
        config's fields}."""
        makedir(path, isfile=True)
        state = {k: v.detach().cpu() for k, v in self.params.state_dict().items()}
        torch.save({"state": state, "config": dataclasses.asdict(self.config)}, path)

    @classmethod
    def load(cls, path: str, device=None) -> "DueModel":
        """A model written by `save`, on `device` (the card unless the CPU
        is named)."""
        blob = torch.load(path, map_location="cpu", weights_only=True)
        config = DueConfig(**blob["config"])
        params = empty_params(config)
        params.load_state_dict(blob["state"], strict=True)
        return cls(params.to(resolve_device(device)), config)

    @torch.no_grad()
    def remove_spectral_norm(self) -> "DueModel":
        """A model whose first layer's weight carries its current spectral
        scale and is no longer re-normalized: the reference strips the torch
        spectral_norm hook from feature_extractor.first so the model is
        plainly differentiable (basic_due.py:176-181). Predictions are
        unchanged; this model is left as it is."""
        net = self.params.net
        scale, u0 = _power_iteration(net.first.weight, net.u_first, self.config.coeff)
        params = empty_params(self.config, self.device)
        params.load_state_dict(self.params.state_dict())
        params.net.first.weight.mul_(scale)
        params.net.u_first.copy_(u0)
        return DueModel(params, dataclasses.replace(self.config, spectral_first=False))


def _initial_values(x_feats: np.ndarray, n_inducing: int, seed: int = 0):
    """k-means inducing locations + mean-distance lengthscale (the DUE
    initial_values recipe), on the host as in coati_tpu."""
    from scipy.cluster.vq import kmeans2

    n = min(1000, len(x_feats))
    idx = np.random.default_rng(seed).permutation(len(x_feats))[:n]
    sample = np.asarray(x_feats[idx], np.float64)
    centers, _ = kmeans2(sample, n_inducing, minit="points", seed=seed)
    # mean pairwise distance by |x-y|^2 = |x|^2 + |y|^2 - 2xy: the (n, n, F)
    # broadcast would be ~2 GB at the default 1000 x 256 sample
    sq = np.sum(sample**2, axis=1)
    d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (sample @ sample.T), 0.0)
    lengthscale = float(np.mean(np.sqrt(d2)))
    return centers.astype(np.float32), max(lengthscale, 1e-2)


def _squeeze_targets(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """-> (N,) float targets; the SVGP is single-output, so multi-target
    label stacks are refused instead of mis-training."""
    y = np.asarray(y, np.float32)
    if y.ndim == 2 and y.shape[1] == 1:
        y = y[:, 0]
    if y.ndim != 1:
        raise ValueError(
            f"train_due fits a single-output GP; got targets of shape "
            f"{y.shape} — train one model per target"
        )
    if len(y) != len(x):
        raise ValueError(f"x/y length mismatch: {len(x)} vs {len(y)}")
    return y


def init_params(config: DueConfig, x: np.ndarray, seed: int, device) -> DueParams:
    """Fresh parameters: the network from a torch generator seeded by
    `seed`, the inducing points by k-means over its features of the first
    1,000 rows, the lengthscale their mean distance."""
    generator = torch.Generator().manual_seed(seed)
    net = FcResNet(config.input_dim, config.features, config.depth, generator).to(device)
    with torch.no_grad():
        feats0, _ = fc_resnet_apply(net, torch.as_tensor(x[:1000], device=device), config.coeff)
    z0, ls0 = _initial_values(feats0.cpu().numpy(), config.n_inducing, seed)
    gp = SvgpParams(config.n_inducing, config.features)
    with torch.no_grad():
        gp.inducing.copy_(torch.as_tensor(z0))
        gp.log_lengthscale.fill_(float(np.float32(np.log(ls0))))
    return DueParams(net, gp.to(device))


def train_due(
    x: np.ndarray,
    y: np.ndarray,
    config: Optional[DueConfig] = None,
    steps: int = 2000,
    batch_size: int = 512,
    seed: int = 0,
    verbose: bool = True,
    init_model: Optional[DueModel] = None,
    device=None,
) -> DueModel:
    """Fit a DUE model on the variational ELBO with Adam. `init_model`
    continues from a copy of its parameters, on its device (the
    reference's load_as + continue_training path, basic_due.py:157-172);
    otherwise the model is made on `device`, the card unless the CPU is
    named. Minibatch indices come from numpy's default_rng(seed), the
    stream coati_tpu draws them from; dropout masks from a torch generator
    seeded by `seed`."""
    x = np.asarray(x, np.float32)
    y = _squeeze_targets(x, y)
    if init_model is not None:
        config = init_model.config
        device = init_model.device
        params = empty_params(config, device)
        params.load_state_dict(init_model.params.state_dict())
    else:
        config = config or DueConfig(input_dim=x.shape[-1])
        device = resolve_device(device)
        params = init_params(config, x, seed, device)
    optimizer = torch.optim.Adam(params.parameters(), lr=config.lr)
    generator = torch.Generator(device=device).manual_seed(seed)
    n_data = len(x)
    x_dev = torch.as_tensor(x, device=device)
    y_dev = torch.as_tensor(y, device=device)
    rng = np.random.default_rng(seed)
    for it in range(int(steps)):
        idx = torch.as_tensor(rng.integers(0, n_data, size=min(batch_size, n_data)), device=device)
        xb, yb = x_dev[idx], y_dev[idx]
        feats, (u_first, u_res) = fc_resnet_apply(
            params.net, xb, config.coeff, config.dropout_rate, generator,
            spectral_first=config.spectral_first,
            spectral_residuals=config.spectral_residuals,
        )
        mean, var = svgp_predict_f(params.gp, feats, jitter=config.jitter,
                                   kxx_jitter=config.kxx_jitter)
        noise = params.gp.log_noise.exp()
        # Gaussian expected log-likelihood, closed form
        ell = -0.5 * (torch.log(2 * math.pi * noise) + ((yb - mean) ** 2 + var) / noise)
        loss = -(ell.mean() * n_data - svgp_kl(params.gp, config.jitter)) / n_data
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        # the power-iteration state moves outside the gradient
        with torch.no_grad():
            params.net.u_first.copy_(u_first)
            params.net.u_res.copy_(u_res)
        if verbose and it % max(1, steps // 10) == 0:
            print(f"due step {it}: elbo loss {float(loss.detach()):.4f}")
    return DueModel(params, config)


def basic_due(
    dataset,
    x_field: str = "emb_smiles",
    y_field: Union[str, List[str]] = "pic50",
    save_as: str = "due_model.pt",
    load_as: Optional[str] = None,
    continue_training: bool = False,
    steps: float = 1e5,
    depth: int = 4,
    batch_size: int = 512,
    remove_spectral_norm: bool = False,
    test_frac: float = 0.03,
    random_seed: int = 510,
    device=None,
):
    """Reference-signature DUE trainer (basic_due.py:14-198): splits the
    record list, trains (or loads), and returns (model, (y_test, mean,
    std))."""
    np.random.seed(seed=random_seed)
    x = np.stack([r[x_field] for r in dataset], 0)
    if isinstance(y_field, str):
        y = np.stack([r[y_field] for r in dataset], 0)
    else:
        y = np.stack([np.stack([r[f] for f in y_field], -1) for r in dataset], 0)
    perm = np.random.permutation(len(dataset))
    test_idx = perm[: int(test_frac * len(dataset))]
    train_idx = perm[int(test_frac * len(dataset)) :]

    steps_per_epoch = max(1, len(train_idx) // batch_size)
    # the reference runs `steps // len(train_loader) + 1` epochs; the loop
    # here stops at the equivalent number of minibatch steps, at most `steps`
    total_steps = int(steps // steps_per_epoch + 1) * steps_per_epoch
    total_steps = min(total_steps, int(steps))

    if load_as is not None:
        model = DueModel.load(load_as, device=device)
        if continue_training:
            # continue from the loaded parameters (basic_due.py:157-172)
            model = train_due(
                x[train_idx], y[train_idx], steps=total_steps,
                batch_size=batch_size, seed=random_seed, init_model=model,
            )
            model.save(save_as)
    else:
        config = DueConfig(input_dim=x.shape[-1], depth=depth)
        model = train_due(
            x[train_idx], y[train_idx], config=config, steps=total_steps,
            batch_size=batch_size, seed=random_seed, device=device,
        )
        model.save(save_as)

    if remove_spectral_norm:
        model = model.remove_spectral_norm()

    mean, std = model.predict(x[test_idx])
    return model, (y[test_idx], mean, std)
