"""COATI's pretraining step, plain.

The loss of a batch is the next-token cross-entropy of the decoder,
averaged over every label that is not -1, plus the symmetric InfoNCE
(CLIP) loss between the SMILES and the point embeddings of the batch's rows
(rows whose decoder tokens are all [PAD] are no one's label), weighted by
log2 of the vocabulary size. The decoder sees, over [UNK], the token of the
point embedding on the rows `pick` marks and of the SMILES embedding on the
rest. The optimizer clips the gradient to a global norm (scaling by
clip / max(norm, clip)) and takes an AdamW step (decoupled weight decay on
every leaf, a leaf the loss does not reach included).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import model
from portbench.reference.egnn import encode_points
from portbench.reference.lowp import EXACT


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _rebuild(pairs):
    tree: dict = {}
    for path, x in pairs:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree


def _ce(logits, labels):
    valid = labels != -1
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, torch.where(valid, labels, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)


def losses(w: dict, cfg: dict, batch: dict, pick: torch.Tensor, q=EXACT, fault=None):
    """(loss, ar_loss, clip_loss) of a batch of device tensors. `fault`
    "half_batch" leaves out the second half of the rows (a planted fault,
    for reading what it does to the numbers compared)."""
    if fault == "half_batch":
        half = batch["tokens"].shape[0] // 2
        batch = {k: v[:half] for k, v in batch.items()}
        pick = pick[:half]
    stop, unk = cfg["stop_token"], cfg["unk_token"]
    h_pts = model.clip_projection(
        w["point_to_clip"],
        encode_points(w["point_encoder"], batch["atoms"], batch["coords"], cfg["egnn_cutoff"], q,
                      remat=True), q)
    raw = batch["raw_tokens"]
    h_smi = model.clip_projection(
        w["smiles_to_clip"],
        model.stop_hidden(model.trunk_hidden(w["xformer"], cfg["n_head"], raw, q=q), raw, stop), q)
    inj = torch.where(pick.reshape(-1, 1), model.injected_token(w, cfg, h_pts, q),
                      model.injected_token(w, cfg, h_smi, q))
    hidden = model.trunk_hidden(w["xformer"], cfg["n_head"], batch["tokens"], inj, unk, q)
    logits = model.lm_logits(w["xformer"], hidden, q)
    ar = _ce(logits.reshape(-1, logits.shape[-1]), batch["y_next"].reshape(-1))
    bad = batch["tokens"].sum(dim=-1) < 1
    scores = h_smi @ h_pts.t()
    labels = torch.where(bad, -1, torch.arange(scores.shape[0], device=scores.device))
    clip = 0.5 * (_ce(scores, labels) + _ce(scores.t(), labels))
    return ar + clip * math.log2(cfg["n_tok"]), ar, clip


def train_steps(w0: dict, cfg: dict, opt: dict, batches, picks, q=EXACT, fault=None,
                moments=None, steps_before: int = 0) -> dict:
    """Follow len(batches) steps from the weights w0, with Adam's moments
    zero, or `moments` (first, second; nested like w0) after
    `steps_before` steps. Returns the losses of each step, the first
    followed step's gradient as the optimizer gets it (clipped) and the
    weights after the last step, as nested dicts."""
    paths, params = zip(*[(p, x.detach().clone().requires_grad_(True)) for p, x in _leaves(w0)])
    if moments is None:
        m = [torch.zeros_like(x) for x in params]
        v = [torch.zeros_like(x) for x in params]
    else:
        first, second = (dict(_leaves(x)) for x in moments)
        m = [first[p].detach().clone() for p in paths]
        v = [second[p].detach().clone() for p in paths]
    b1, b2 = opt["betas"]
    out = {"losses": []}
    for t, (batch, pick) in enumerate(zip(batches, picks), start=steps_before + 1):
        loss, ar, clip = losses(_rebuild(zip(paths, params)), cfg, batch, pick, q, fault)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(params, grads)]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        scale = opt["clip_grad"] / norm.clamp_min(opt["clip_grad"])
        grads = [g * scale for g in grads]
        if t == steps_before + 1:
            out["first_grad"] = _rebuild(zip(paths, grads))
        out["losses"].append([float(loss.detach()), float(ar.detach()), float(clip.detach())])
        with torch.no_grad():
            for x, g, mi, vi in zip(params, grads, m, v):
                x.mul_(1 - opt["lr"] * opt["weight_decay"])
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi.sqrt() / math.sqrt(1 - b2 ** t)).add_(opt["eps"])
                x.addcdiv_(mi, denom, value=-opt["lr"] / (1 - b1 ** t))
    out["params"] = _rebuild(zip(paths, [x.detach() for x in params]))
    return out
