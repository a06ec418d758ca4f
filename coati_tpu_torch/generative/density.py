"""Embedding-space density estimation.

Counterpart of coati_tpu/generative/density.py (itself the reference's
coati_density): a full-covariance multivariate normal over COATI
embeddings, fitted by SGD on the batch negative log-likelihood with a
Cholesky parameterization and an entropy stop, or in closed form. The
fitted density is the sampling prior of virtual screens. Its tensors live
on the device of the embeddings it was fitted to.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self
from coati_tpu_torch.common.util import batch_indexable
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

SGD_LR = 5e-3


@dataclass
class MvnDensity:
    """Multivariate normal with a lower-triangular Cholesky factor."""

    mean: torch.Tensor  # (D,)
    scale_tril: torch.Tensor  # (D, D) lower triangular

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        diff = x - self.mean
        # solve L z = diff; log det = sum log |diag L|
        z = torch.linalg.solve_triangular(self.scale_tril, diff.T, upper=False).T
        logdet = torch.log(torch.abs(torch.diagonal(self.scale_tril))).sum()
        return -0.5 * z.square().sum(dim=-1) - logdet - 0.5 * self.dim * math.log(2.0 * math.pi)

    def sample(self, generator: torch.Generator, shape=()) -> torch.Tensor:
        """Draws from `generator`, which must be on the density's device."""
        eps = torch.randn(tuple(shape) + (self.dim,), generator=generator,
                          device=self.mean.device, dtype=self.mean.dtype)
        return self.mean + eps @ self.scale_tril.T


def _build_density(params) -> MvnDensity:
    sq_diag, lower, mean = params["sq_diag"], params["lower"], params["mean"]
    d = sq_diag.shape[0]
    rows, cols = torch.tril_indices(d, d, offset=-1, device=sq_diag.device)
    tril = torch.diag(sq_diag * sq_diag).index_put((rows, cols), lower)
    return MvnDensity(mean=mean, scale_tril=tril)


def _density_step(params, optimizer: torch.optim.Optimizer, embeds: torch.Tensor) -> float:
    """One SGD step on the mean negative log-likelihood of `embeds`;
    returns that loss (the entropy estimate) of the parameters before the
    step. The mean is not in the optimizer: it stays where it started."""
    optimizer.zero_grad(set_to_none=True)
    entropy = -_build_density(params).log_prob(embeds).mean()
    entropy.backward()
    optimizer.step()
    return float(entropy.detach())


def estimate_density_batchwise(
    iterable: Iterable[str],
    encoder: COATI,
    tokenizer: TrieTokenizer,
    batch_size: int = 1024,
    epochs: int = 10,
    entropy_limit: float = -100.0,
    verbose: bool = True,
) -> Optional[MvnDensity]:
    """SGD-fit an MVN to the embeddings of `iterable` SMILES. Returns the
    density once the mean negative log-probability of a batch falls under
    entropy_limit (the density of the parameters that batch measured,
    before its step, as the reference returns it), else None."""
    d = encoder.embed_dim
    device = encoder.device
    params = {
        "mean": torch.zeros((d,), device=device),
        "sq_diag": torch.full((d,), 0.5, device=device, requires_grad=True),
        "lower": torch.zeros((d * (d - 1) // 2,), device=device, requires_grad=True),
    }
    optimizer = torch.optim.SGD([params["sq_diag"], params["lower"]], lr=SGD_LR)

    for _ in range(epochs):
        for batch in batch_indexable(list(iterable), batch_size):
            tokens = []
            for s in batch:
                try:
                    cs = canonicalize_or_self(s)
                    tokens.append(tokenizer.tokenize_text("[SMILES]" + cs + "[STOP]", pad=True))
                except (KeyError, ValueError):
                    continue
            if not tokens:
                continue
            embeds = encoder.encode_tokens(np.asarray(tokens, np.int32), tokenizer).float()
            before = _build_density({k: v.detach().clone() for k, v in params.items()})
            entropy = _density_step(params, optimizer, embeds)
            if verbose:
                print(f"entropy: {entropy:.4f}")
            if entropy < entropy_limit:
                return before
    return None


def fit_density_closed_form(embeds, jitter: float = 1e-4) -> MvnDensity:
    """Exact maximum-likelihood fit (mean and the Cholesky factor of the
    empirical covariance, in float64) of (N, D) embeddings, numpy or a
    tensor: what the SGD loop converges to, in one step. The density is
    float32, on the tensor's device (the CPU for numpy)."""
    device = embeds.device if isinstance(embeds, torch.Tensor) else torch.device("cpu")
    if isinstance(embeds, torch.Tensor):
        embeds = embeds.detach().float().cpu().numpy()
    x = np.asarray(embeds, np.float64)
    mean = x.mean(0)
    cov = np.cov(x.T) + jitter * np.eye(x.shape[1])
    tril = np.linalg.cholesky(cov)
    return MvnDensity(mean=torch.tensor(mean, dtype=torch.float32, device=device),
                      scale_tril=torch.tensor(tril, dtype=torch.float32, device=device))
