"""Metadynamics generative optimization in COATI embedding space.

PyTorch counterpart of coati_tpu/generative/metadynamics.py, the
reconstruction of the reference's metadynamics MPO workflow
(examples/metadynamics/metadynamics.ipynb, described in its README.md:9,
with the DUE artifacts due_qed_barlow.pt / due_logp_barlow.pt /
due_hcaii_barlow_terray.pt): design molecules that satisfy a
multi-parameter objective by walking the invertible embedding space under
property objectives plus a repulsive history bias, Gaussian hills dropped
at visited points, so that the walker keeps finding new molecules instead
of re-sampling one optimum.

Objective terms are functions of a (D,) float32 tensor on the walker's
device that return a scalar tensor; the walk ascends their exact gradient
(torch.autograd). Candidate molecules come from the batched KV-cache
decoder with validity filtering. The exploration noise is numpy's
default_rng(seed), the stream coati_tpu draws it from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from coati_tpu_torch.chem.rdkit_support import canonicalize_or_self, is_valid_smiles
from coati_tpu_torch.common.util import resolve_device
from coati_tpu_torch.generative.purifications import UNUSABLE_DECODE, embed_smiles_batch
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

Objective = Callable[[torch.Tensor], torch.Tensor]


@dataclass
class MetadynamicsConfig:
    steps: int = 50
    step_size: float = 0.05  # gradient-ascent step on the objective
    hill_height: float = 1.0  # repulsive bias amplitude
    hill_width: float = 1.0  # gaussian hill sigma in embedding space
    noise_scale: float = 0.05  # exploration noise per step
    decode_batch: int = 32  # decodes per step to realize molecules
    inv_temp: float = 2.0
    k: int = 100
    re_embed: bool = True  # snap the walker to embed(decode(v)) each step
    seed: int = 0


@dataclass
class MetadynamicsResult:
    smiles: List[str]
    scores: List[float]
    vectors: np.ndarray
    history: List[Dict]
    best_smiles: str = ""
    best_score: float = -np.inf

    def top(self, n: int = 10):
        order = np.argsort(self.scores)[::-1][:n]
        return [(self.smiles[i], self.scores[i]) for i in order]


def gaussian_hills_bias(
    v: torch.Tensor, centers: torch.Tensor, height: float, width: float
) -> torch.Tensor:
    """Sum of repulsive Gaussian hills at visited centers (the metadynamics
    history bias). centers: (H, D); v: (D,)."""
    d2 = ((v[None, :] - centers) ** 2).sum(-1)
    return height * torch.exp(-0.5 * d2 / width**2).sum()


def _make_ascend(objective_fn: Objective, cfg: MetadynamicsConfig, max_hills: int):
    """One gradient-ascent step on objective - history bias, the bias over
    the first n_hills of max_hills centers."""

    def ascend(v: torch.Tensor, centers: torch.Tensor, n_hills: int):
        v = v.detach().requires_grad_(True)
        mask = torch.arange(max_hills, device=v.device) < n_hills
        d2 = ((v[None, :] - centers) ** 2).sum(-1)
        bias = cfg.hill_height * torch.where(
            mask, torch.exp(-0.5 * d2 / cfg.hill_width**2), torch.zeros_like(d2)).sum()
        score = objective_fn(v) - bias
        (grad,) = torch.autograd.grad(score, v)
        return (v + cfg.step_size * grad).detach(), score.detach()

    return ascend


def _objective_value(objective_fn: Objective, v: torch.Tensor) -> float:
    with torch.no_grad():
        return float(objective_fn(v))


def walk_embedding_space(
    objective_fn: Objective,
    v0: np.ndarray,
    config: Optional[MetadynamicsConfig] = None,
    device=None,
):
    """Pure embedding-space metadynamics walk: the ascend / hill dynamics of
    run_metadynamics without the decode and re-embed (no molecules
    realized), on `device` (the card unless the CPU is named).

    Returns numpy (positions (steps+1, D), objectives (steps+1,)): position 0
    is v0 and objectives[i] = objective_fn(positions[i]), without the bias
    term, so the trace measures the objective's progress."""
    cfg = config or MetadynamicsConfig()
    device = resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    v = torch.as_tensor(np.asarray(v0, np.float32).reshape(-1), device=device)
    dim = v.shape[0]
    max_hills = max(cfg.steps, 1)
    centers = torch.zeros((max_hills, dim), device=device)
    n_hills = 0
    ascend = _make_ascend(objective_fn, cfg, max_hills)

    positions = [v.cpu().numpy()]
    objectives = [_objective_value(objective_fn, v)]
    for _ in range(cfg.steps):
        v, _ = ascend(v, centers, n_hills)
        if cfg.noise_scale > 0:
            noise = rng.normal(scale=cfg.noise_scale, size=(dim,)).astype(np.float32)
            v = v + torch.as_tensor(noise, device=device)
        centers[n_hills % max_hills] = v
        n_hills = min(n_hills + 1, max_hills)
        positions.append(v.cpu().numpy())
        objectives.append(_objective_value(objective_fn, v))
    return np.stack(positions, 0), np.asarray(objectives)


def run_metadynamics(
    encoder: COATI,
    tokenizer: TrieTokenizer,
    objective_fn: Objective,
    v0: np.ndarray,
    config: Optional[MetadynamicsConfig] = None,
) -> MetadynamicsResult:
    """Metadynamics walk maximizing objective_fn(v) - history_bias(v), on
    the encoder's device.

    objective_fn maps a (D,) embedding to a scalar score (e.g. a weighted
    sum of DUE predictive means) and must be differentiable by autograd.
    Whatever a decode raises reaches the caller; only the tokenizing of a
    decoded SMILES is caught, to leave out molecules the tokenizer cannot
    take."""
    cfg = config or MetadynamicsConfig()
    device = encoder.device
    rng = np.random.default_rng(cfg.seed)
    dim = encoder.embed_dim
    v = torch.as_tensor(np.asarray(v0, np.float32).reshape(dim), device=device)
    max_hills = cfg.steps
    centers = torch.zeros((max_hills, dim), device=device)
    n_hills = 0
    ascend = _make_ascend(objective_fn, cfg, max_hills)

    all_smiles: List[str] = []
    all_scores: List[float] = []
    all_vectors: List[np.ndarray] = []
    history: List[Dict] = []
    best_smiles, best_score = "", -np.inf
    seen = set()

    for step in range(cfg.steps):
        v, _ = ascend(v, centers, n_hills)
        noise = rng.normal(scale=cfg.noise_scale, size=(dim,)).astype(np.float32)
        v = v + torch.as_tensor(noise, device=device)

        # realize molecules at the walker position
        decoded = encoder.hclip_to_2d_batch(
            np.tile(v.cpu().numpy()[None, :], (cfg.decode_batch, 1)),
            tokenizer, inv_temp=cfg.inv_temp, k=cfg.k,
        )
        valid = [canonicalize_or_self(s) for s in decoded if is_valid_smiles(s)]
        # drop molecules the tokenizer cannot round-trip (oversized, foreign)
        uniq = []
        for s in sorted(set(valid)):
            try:
                tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)
            except UNUSABLE_DECODE:
                continue
            uniq.append(s)
        valid = uniq
        step_vec = None
        n_new = 0
        if valid:
            embs = embed_smiles_batch(uniq, encoder, tokenizer)
            scores = [_objective_value(objective_fn, torch.as_tensor(e, device=device))
                      for e in embs]
            for s, sc, e in zip(uniq, scores, embs):
                if s not in seen:
                    seen.add(s)
                    all_smiles.append(s)
                    all_scores.append(sc)
                    all_vectors.append(np.asarray(e))
                    n_new += 1
                if sc > best_score:
                    best_score, best_smiles = sc, s
            step_vec = np.asarray(embs[int(np.argmax(scores))])

        # drop a repulsive hill at the visited location
        centers[n_hills % max_hills] = v
        n_hills = min(n_hills + 1, max_hills)

        # snap the walker back onto the molecule manifold
        if cfg.re_embed and step_vec is not None:
            v = torch.as_tensor(step_vec, device=device)

        history.append(
            {
                "step": step,
                "walker_norm": float(torch.linalg.vector_norm(v)),
                # newly discovered molecules this step (seen-set admissions):
                # a converged walker re-decoding known molecules reads 0
                "n_new": n_new,
                "n_valid": len(valid),
                "best_smiles": best_smiles,
                "best_score": best_score,
            }
        )

    return MetadynamicsResult(
        smiles=all_smiles,
        scores=all_scores,
        vectors=np.stack(all_vectors, 0) if all_vectors else np.zeros((0, dim)),
        history=history,
        best_smiles=best_smiles,
        best_score=best_score,
    )


def combined_objective(
    terms: Sequence[Objective], weights: Optional[Sequence[float]] = None
) -> Objective:
    """Weighted multi-parameter objective, e.g. potency + QED + logP terms
    from DUE regressors (the reference MPO: potency, solubility,
    druglikeness)."""
    weights = list(weights or [1.0] * len(terms))

    def fn(v):
        total = torch.zeros((), device=v.device)
        for w, t in zip(weights, terms):
            total = total + w * t(v)
        return total

    return fn


def due_objective(due_model, scale: float = 1.0) -> Objective:
    """A trained DueModel's predictive mean as a differentiable objective
    term over a single embedding vector."""
    d_in = int(due_model.config.input_dim)

    def fn(v):
        if v.shape[-1] != d_in:
            raise ValueError(
                f"DUE property model expects {d_in}-d embeddings but the "
                f"COATI model produced {v.shape[-1]}-d — the published "
                f"due_*_barlow.pt artifacts were trained on barlow_closed's "
                f"256-d space; pair them with a matching model document"
            )
        mean, _ = due_model.mean_and_var(v[None, :])
        return scale * mean[0]

    return fn
