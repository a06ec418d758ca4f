"""Import the published torch DUE property models.

Counterpart of coati_tpu/regression/due_import.py. The reference ships
trained DUE/DKL regressors as torch artifacts: full pickled modules
(`torch.load("due_qed_june.pt")`, consumed by
examples/simple_mol_generation/generation_examples.ipynb) and state-dict
saves (the `save_as` path of coati/models/regression/basic_due.py:175).
They reference the `due`/`gpytorch`/`linear_operator` packages, which this
package does not depend on; `load_torch_due` unpickles them with generated
stub classes, extracts the tensors, and converts them to a `DueModel`
(regression/due.py) whose predictions match the torch eval forward.

Conversion math (all float64, folded once at import):

* FCResNet (due/fc_resnet.py): torch eval computes each
  spectral-normalized weight as W_eff = W_orig / max(1, sigma/coeff)
  with sigma = u . (W_orig v) from the stored power-iteration vectors
  (due/layers/spectral_norm_fc.py `compute_weight`,
  do_power_iteration=False at eval). W_eff is folded into the stored
  weights, which then run as plain linears (spectral_* flags False).
  Published metadynamics artifacts were saved after
  remove_spectral_norm stripped the FIRST layer's hook
  (basic_due.py:176-181), detected per layer by which keys exist.

* GP (due/dkl.py GP = gpytorch ApproximateGP + whitened
  VariationalStrategy): gpytorch's eval predictive is
      mean = c + A^T m_w,          A = L^{-1} K_zx
      var  = diag(Kxx) + j - colsum(A*A) + colsum((S_w^T A)^2)
  with L = chol(Kzz + j I), j = 1e-4 (gpytorch
  variational_strategy.py jitter_val), m_w/S_w the WHITENED
  variational mean/cholesky, c the ConstantMean constant. The SVGP here
  (svgp_predict_f) is non-whitened: mean = Kxz Kzz^{-1} mu + c, covar
  term a^T S S^T a with a = Kzz^{-1} Kzx. The exact transform:
      mu = L m_w
      S: lower-triangular with S S^T = (L S_w)(L S_w)^T  (LQ of L S_w)
  and jitter/kxx_jitter = 1e-4 so the solves match gpytorch's.
"""

from __future__ import annotations

import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch

from coati_tpu_torch.common.util import resolve_device
from coati_tpu_torch.regression.due import DueConfig, DueModel, empty_params

_GPYTORCH_JITTER = 1e-4  # gpytorch.settings.variational_cholesky_jitter (f32)
_STUB_PREFIXES = ("due", "gpytorch", "linear_operator")


class _Stub:
    """Shape-preserving stand-in for a missing pickled class: keeps the
    pickled attribute dict, answers unknown attribute lookups with None
    (torch's module unpickler getattr's hook plumbing mid-load)."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return None

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            d, s = state
            if isinstance(d, dict):
                self.__dict__.update(d)
            if isinstance(s, dict):
                self.__dict__.update(s)
        else:
            self.__dict__["_stub_state"] = state


def _fake_module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    cache: Dict[str, type] = {}

    def _getattr(attr, _name=name):
        if attr.startswith("__"):
            raise AttributeError(attr)
        if attr not in cache:
            cache[attr] = type(attr, (_Stub,), {"__module__": _name})
        return cache[attr]

    mod.__getattr__ = _getattr
    mod.__path__ = []  # mark as package so submodule imports resolve
    mod.__coati_stub__ = True  # lets _stubs_installed evict on exit
    return mod


class _StubImporter:
    """sys.meta_path finder serving fake modules for the absent
    due/gpytorch/linear_operator package trees."""

    def find_spec(self, fullname, path=None, target=None):
        import importlib.machinery

        if fullname.split(".")[0] not in _STUB_PREFIXES:
            return None
        return importlib.machinery.ModuleSpec(fullname, self, is_package=True)

    def create_module(self, spec):
        return _fake_module(spec.name)

    def exec_module(self, module):
        pass


class _stubs_installed:
    """Context manager scoping the stub finder to the unpickle: a
    process-lifetime finder would make every later `import gpytorch`
    silently succeed with fakes, turning a clean ImportError elsewhere
    into confusing None-propagation. Appended at the END of
    sys.meta_path, so real installations always win even inside the
    scope; removed on exit (stub MODULES cached in sys.modules by the
    unpickle are also evicted so nothing fake leaks)."""

    def __enter__(self):
        self._finder = None
        if not any(isinstance(f, _StubImporter) for f in sys.meta_path):
            self._finder = _StubImporter()
            sys.meta_path.append(self._finder)
        return self

    def __exit__(self, *exc):
        if self._finder is not None:
            sys.meta_path.remove(self._finder)
            for name in [
                n for n in sys.modules
                if n.split(".")[0] in _STUB_PREFIXES
                and getattr(sys.modules[n], "__coati_stub__", False)
            ]:
                del sys.modules[name]


# ------------------------------------------------- module-tree walking


def _children(obj) -> Dict[str, object]:
    return dict(getattr(obj, "_modules", None) or {})


def _tensors(obj) -> Dict[str, "np.ndarray"]:
    out = {}
    for src in ("_parameters", "_buffers"):
        for k, v in (getattr(obj, src, None) or {}).items():
            if v is not None and hasattr(v, "detach"):
                out[k] = v.detach().cpu().numpy()
    return out


def _flatten_module(obj, prefix="") -> Dict[str, np.ndarray]:
    """state_dict-equivalent flat {dotted_name: ndarray} from a pickled
    (possibly stubbed) torch module tree."""
    flat = {}
    for k, v in _tensors(obj).items():
        flat[prefix + k] = v
    for name, child in _children(obj).items():
        flat.update(_flatten_module(child, prefix + name + "."))
    return flat


def _find_coeff(obj, default: float = 0.95) -> float:
    """Pull the Lipschitz coeff out of a SpectralNormFC pre-hook if the
    pickled module still carries one (basic_due.py passes coeff=0.95)."""
    for hook in (getattr(obj, "_forward_pre_hooks", None) or {}).values():
        coeff = getattr(hook, "coeff", None)
        if coeff is not None:
            return float(coeff)
    for child in _children(obj).values():
        found = _find_coeff(child, default=-1.0)
        if found > 0:
            return found
    return default


def load_due(path: str, device=None) -> DueModel:
    """Load a DUE model from either format: `.pt` -> a published torch
    artifact (load_torch_due), anything else -> this package's own file
    (DueModel.load). On `device`, the card unless the CPU is named."""
    if path.endswith(".pt"):
        return load_torch_due(path, device=device)
    return DueModel.load(path, device=device)


def load_torch_due(path: str, device=None) -> DueModel:
    """Load a published torch DUE artifact (full pickled DKL module, the
    format of examples/metadynamics/due_*.pt, or a bare state_dict, the
    basic_due.py save_as format) and convert it to a DueModel on `device`.
    Unpickling runs code: load only artifacts of a source you trust."""
    with _stubs_installed():
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):  # a state_dict
        sd = {k: v.detach().cpu().numpy() for k, v in obj.items() if hasattr(v, "detach")}
        coeff = 0.95  # basic_due.py:75, not recoverable from a state_dict
    else:
        sd = _flatten_module(obj)
        coeff = _find_coeff(obj)
    return convert_due_state_dict(sd, coeff=coeff, device=device)


# ----------------------------------------------------------- convert


def _softplus(x):
    return np.logaddexp(0.0, x)


def _fold_spectral(sd, prefix: str, coeff: float) -> Tuple[np.ndarray, np.ndarray]:
    """-> (W_eff (out, in), u) for one linear layer, replicating the torch
    eval forward: plain `weight` if the hook was removed, else
    W_orig / max(1, sigma/coeff) with sigma = u . (W_orig v)
    (due/layers/spectral_norm_fc.py compute_weight, eval path)."""
    if prefix + "weight" in sd:
        w = np.asarray(sd[prefix + "weight"], np.float64)
        return w, np.ones(w.shape[0]) / np.sqrt(w.shape[0])
    w = np.asarray(sd[prefix + "weight_orig"], np.float64)
    u = np.asarray(sd[prefix + "weight_u"], np.float64)
    v = np.asarray(sd[prefix + "weight_v"], np.float64)
    sigma = float(u @ (w @ v))
    return w / max(1.0, sigma / coeff), u


def convert_due_state_dict(sd: Dict[str, np.ndarray], coeff: float = 0.95,
                           device=None) -> DueModel:
    """Convert a torch DUE/DKL state dict (flat {name: ndarray}) into a
    DueModel with identical eval predictions, on `device` (the card unless
    the CPU is named). See the module docstring for the whitened to
    non-whitened variational transform."""
    fe = "feature_extractor."
    first_w, first_u = _fold_spectral(sd, fe + "first.", coeff)
    first_b = np.asarray(sd[fe + "first.bias"], np.float64)
    depth = 0
    while fe + f"residuals.{depth}.bias" in sd:
        depth += 1
    if depth == 0:
        raise ValueError(f"no residual layers found; keys: {sorted(sd)[:10]}...")
    res = [_fold_spectral(sd, fe + f"residuals.{i}.", coeff) for i in range(depth)]
    res_b = [np.asarray(sd[fe + f"residuals.{i}.bias"], np.float64) for i in range(depth)]

    gp = "gp.variational_strategy."
    z = np.asarray(sd[gp + "inducing_points"], np.float64)
    m_w = np.asarray(sd[gp + "_variational_distribution.variational_mean"], np.float64)
    s_w = np.tril(np.asarray(sd[gp + "_variational_distribution.chol_variational_covar"],
                             np.float64))
    if m_w.ndim != 1:
        raise ValueError(
            f"multi-output DUE artifacts are not supported (variational "
            f"mean shape {m_w.shape}); the published models are all "
            "single-output"
        )
    raw_ls = np.asarray(sd["gp.covar_module.base_kernel.raw_lengthscale"], np.float64)
    raw_os = np.asarray(sd["gp.covar_module.raw_outputscale"], np.float64)
    # gpytorch renamed ConstantMean's parameter constant -> raw_constant
    # (identity constraint by default); accept either
    c_key = ("gp.mean_module.raw_constant" if "gp.mean_module.raw_constant" in sd
             else "gp.mean_module.constant")
    c = float(np.asarray(sd[c_key], np.float64).reshape(-1)[0])
    lengthscale = float(_softplus(raw_ls).reshape(-1)[0])
    outputscale = float(_softplus(raw_os).reshape(-1)[0])

    # Kzz under gpytorch's jitter; whiten-transform the variational params
    d2 = np.sum(z**2, -1)[:, None] + np.sum(z**2, -1)[None, :] - 2.0 * z @ z.T
    kzz = outputscale * np.exp(-0.5 * np.maximum(d2, 0.0) / lengthscale**2)
    lzz = np.linalg.cholesky(kzz + _GPYTORCH_JITTER * np.eye(len(z)))
    mu = lzz @ m_w
    b = lzz @ s_w
    # lower-triangular S with S S^T = B B^T via LQ (qr of B^T); B may be
    # singular (tiny whitened-cholesky diagonals), so no PSD cholesky
    _, r = np.linalg.qr(b.T)
    s = r.T

    config = DueConfig(
        input_dim=first_w.shape[1],
        features=first_w.shape[0],
        depth=depth,
        n_inducing=len(z),
        coeff=coeff,
        dropout_rate=0.0,  # eval-time model
        spectral_first=False,
        spectral_residuals=False,  # factors folded above
        jitter=_GPYTORCH_JITTER,
        kxx_jitter=_GPYTORCH_JITTER,
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    state = {
        "net.first.weight": f32(first_w),
        "net.first.bias": f32(first_b),
        "net.u_first": f32(first_u),
        "net.u_res": f32(np.stack([u for _, u in res])),
        "gp.inducing": f32(z),
        "gp.var_mean": f32(mu),
        "gp.var_chol": f32(s),
        "gp.log_lengthscale": f32(np.log(lengthscale)),
        "gp.log_outputscale": f32(np.log(outputscale)),
        # the likelihood is not saved in the artifacts; predictions use f's std
        "gp.log_noise": f32(np.log(0.5)),
        "gp.mean_const": f32(c),
    }
    for i, ((w, _), bias) in enumerate(zip(res, res_b)):
        state[f"net.res.{i}.weight"] = f32(w)
        state[f"net.res.{i}.bias"] = f32(bias)
    params = empty_params(config)
    params.load_state_dict(state, strict=True)
    return DueModel(params.to(resolve_device(device)), config)
