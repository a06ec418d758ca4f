"""Pretraining through the program's own trainer, `train_autoencoder`,
with the recipe the workload names, from weights drawn from the seed and
handed over as the resume document, on rows this driver's dataset object
supplies: the fixture's molecules (SMILES with atoms and coordinates) in
passes the seed shuffles, batches of distinct molecules, atoms padded to
the trainer's buckets. The trainer's own transform runs serially on each
batch, spanned here. The first `warmup_steps` steps are set-up; the pipe
closes at the window's deadline.

Correct, in two parts. The start: the optimizer's hooks keep the
program's parameters before the first step, its first moment after the
first (the first gradient as the optimizer got it, clipped) and its
parameters after the third; the reference follows the same three steps
from the same seeded weights, in float32. A step of the window (the
`seed % 8`-th): the hooks keep the program's parameters and Adam's moments
before it and after it; the reference follows that one step from the
program's own state (parameters and moments), in float32. Both take the
program's transformed batches as they are, and the transform is checked by
itself: each row's next-token labels are its decoder tokens shifted by
one, special tokens masked; its target SMILES and its decoder row hold its
molecule's heavy atoms, element by element. The recipe fixes the
clip-token choice (`p_clip_emb_smi` 0: every row injects its point
embedding's token), so the reference follows no random draw of the
program's."""

from __future__ import annotations

import os
import pickle
import random
import re
import sys
import tempfile
from collections import Counter
from contextlib import redirect_stdout

import numpy as np
import torch

from portbench import checks
from portbench.costs import PEAK_FLOPS, kernels
from portbench.costs import model as flops
from portbench.harness import ROOT, ManualProfile, now, sync
from portbench.reference import weights
from portbench.reference.tokenizer import Vocabulary
from portbench.reference.train import train_steps

FOLLOWED = 3  # steps the reference follows from the seeded weights
WINDOW_STEPS = 8  # the followed window step is one of the window's first this many


class Pipe:
    """The dataset object the trainer takes: get_data_pipe(...) yields
    transformed batches until the window's deadline, keeping what the
    check and the metrics read."""

    summary = {"dataset_type": "portbench_fixture"}

    def __init__(self, ctx):
        t = ctx.traffic
        with np.load(ROOT / t["fixture"]) as z:
            self.smiles = [str(s) for s in z["smiles"]]
            self.atoms = z["atoms"].astype(np.int32)
            self.coords = z["coords"].astype(np.float32)
        self.ctx = ctx
        self.batch_size = t["batch_size"]
        self.buckets = t["atom_buckets"]
        self.rng = np.random.default_rng(ctx.seed)
        self.order = []
        self.first = []  # the first FOLLOWED transformed batches
        self.window_step = t["warmup_steps"] + ctx.seed % WINDOW_STEPS
        self.window_batch = None  # the transformed batch of the followed window step
        self.in_window = []  # (tokens, raw_tokens, atoms, coords) of each window step
        self.opened = self.closed = None
        self.trace = None
        self.traced_batches = []  # (atoms, coords) of the profiled steps

    def _rows(self):
        per_pass = len(self.smiles) // self.batch_size * self.batch_size
        if len(self.order) < self.batch_size:
            self.order = list(self.rng.permutation(len(self.smiles))[:per_pass])
            if self.opened is None and not self.first:
                # the first batch holds the largest molecule: set-up meets
                # the widest atom bucket
                big = int((self.atoms > 0).sum(1).argmax())
                if big not in self.order[: self.batch_size]:
                    j = self.order.index(big) if big in self.order else 0
                    self.order[0], self.order[j] = big, self.order[0]
        rows, self.order = self.order[: self.batch_size], self.order[self.batch_size:]
        return rows

    def _stack(self, rows):
        n = int((self.atoms[rows] > 0).sum(1).max())
        n = next((b for b in self.buckets if n <= b), n)
        return {"smiles": np.asarray([self.smiles[r] for r in rows], dtype=object),
                "source_collection": np.asarray([self.ctx.traffic["collection"]] * len(rows),
                                                dtype=object),
                "atoms": self.atoms[rows, :n].copy(), "coords": self.coords[rows, :n].copy()}

    def get_data_pipe(self, xform_routine=lambda b: b, batch_size=None, **kwargs):
        if batch_size not in (None, self.batch_size):
            raise ValueError(f"the trainer asks for batches of {batch_size}, the cell gives "
                             f"{self.batch_size}")
        ctx = self.ctx
        warm, traced = ctx.traffic["warmup_steps"], ctx.traffic["traced_steps"]
        profile = None
        step = 0
        while True:
            if step == warm:
                sync(ctx.device)
                self.opened = now()
                ctx.spans.on = True
            if self.opened is not None and self.closed is None and step > self.window_step \
                    and now() - self.opened >= ctx.seconds:
                sync(ctx.device)
                self.closed, self.window_steps = now(), step - warm
                ctx.spans.on = False
                if not ctx.trace:
                    return
                profile = ManualProfile(ctx.device)
                profile.start()
            if profile is not None and step == warm + self.window_steps + traced:
                self.trace = profile.stop()
                return
            raw = self._stack(self._rows())
            with ctx.spans("xform"):
                batch = xform_routine(raw)
            kept = {k: np.asarray(batch[k]).copy()
                    for k in ("raw_tokens", "tokens", "y_next", "atoms", "coords")} \
                if step < FOLLOWED or step == self.window_step else None
            if step < FOLLOWED:
                self.first.append(kept)
            elif self.opened is not None and self.closed is None:
                self.in_window.append(
                    (batch["tokens"], batch["raw_tokens"], batch["atoms"], batch["coords"]))
            elif profile is not None:
                self.traced_batches.append((batch["atoms"], batch["coords"]))
            if step == self.window_step:
                self.window_batch = kept
            step += 1
            yield batch


class Hooks:
    """The optimizer's state at the steps the check reads, keyed by
    parameter object: parameters before the first step and after the
    third, the first moment after the first; and parameters and both
    moments before the followed window step, parameters and the first
    moment after it."""

    def __init__(self, window_step: int):
        from torch.optim.optimizer import (
            register_optimizer_step_post_hook,
            register_optimizer_step_pre_hook,
        )

        self.steps = 0
        self.window_step = window_step
        self.before, self.first_moment, self.after = {}, {}, {}
        self.window = {}
        self.beta1 = None
        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]

    def _params(self, opt):
        return [p for g in opt.param_groups for p in g["params"]]

    def _moment(self, opt, key):
        # a step that made no moment leaves a zero one
        return {id(p): opt.state[p].get(key, torch.zeros_like(p)).detach().clone()
                for p in self._params(opt)}

    def _pre(self, opt, args, kwargs):
        if self.steps == 0:
            self.before = {id(p): p.detach().clone() for p in self._params(opt)}
        if self.steps == self.window_step:
            self.window.update(before={id(p): p.detach().clone() for p in self._params(opt)},
                               m=self._moment(opt, "exp_avg"), v=self._moment(opt, "exp_avg_sq"))

    def _post(self, opt, args, kwargs):
        self.steps += 1
        if self.steps == 1:
            self.beta1 = opt.param_groups[0]["betas"][0]
            self.first_moment = self._moment(opt, "exp_avg")
        if self.steps == FOLLOWED:
            self.after = {id(p): p.detach().clone() for p in self._params(opt)}
        if self.steps == self.window_step + 1:
            self.window.update(after={id(p): p.detach().clone() for p in self._params(opt)},
                               m_after=self._moment(opt, "exp_avg"))
            self.remove()

    def remove(self):
        for h in self._handles:
            h.remove()
        self._handles = []


def recipe(ctx, resume: str):
    from coati_tpu_torch.training import config as train_config

    cfg = getattr(train_config, f"{ctx.traffic['recipe']}_config")(
        dtype=ctx.cfg["dtype"], n_epochs=1, resume_document=resume, **ctx.traffic["overrides"])
    for key in ("n_layer_xformer", "n_hidden_xformer", "n_head", "n_layer_e3gnn",
                "n_hidden_e3nn", "n_embd_common"):
        if getattr(cfg, key) != ctx.cfg[key]:
            raise ValueError(f"recipe {key} {getattr(cfg, key)} is not the configuration's")
    return cfg


class State:
    pass


def setup(ctx):
    state = State()
    vocab = Vocabulary(ctx.cfg["vocab"])
    ctx.cfg = dict(ctx.cfg, stop_token=vocab.stop, unk_token=vocab.unk)
    state.pipe = Pipe(ctx)
    state.dir = tempfile.TemporaryDirectory(prefix="portbench_")
    state.resume = os.path.join(state.dir.name, "start.pkl")
    tree = weights.seeded(ctx.cfg, ctx.seed, ctx.device)
    with open(state.resume, "wb") as f:
        pickle.dump(weights.document(tree, ctx.cfg), f, protocol=pickle.HIGHEST_PROTOCOL)
    del tree
    state.config = recipe(ctx, state.resume)
    return state


def window(ctx, state):
    from coati_tpu_torch.training.train import train_autoencoder

    state.hooks = Hooks(state.pipe.window_step)
    random.seed(ctx.seed)  # the transform draws from the global random module
    with redirect_stdout(sys.stderr):
        model, results = train_autoencoder(state.config, state.pipe, device=ctx.device,
                                           seed=ctx.seed)
    sync(ctx.device)
    state.hooks.remove()
    pipe = state.pipe
    state.names = {id(p): n for n, p in model.named_parameters()}
    state.losses = [h[3] for h in results["history"][:FOLLOWED]]
    state.window_loss = results["history"][pipe.window_step][3]
    state.model = model
    window_s = pipe.closed - pipe.opened
    rows = pipe.window_steps * state.config.batch_size
    record = {"window_s": window_s, "spans": dict(ctx.spans.seconds),
              "steps": pipe.window_steps, "peak_flops": PEAK_FLOPS[ctx.cfg["dtype"]],
              "model_flops": sum(step_flops(ctx.cfg, *b) for b in pipe.in_window)}
    return {"opened": pipe.opened, "attempted": pipe.window_steps, "failed": 0,
            "metrics": {"train_mol_per_s": rows / window_s}, "record": record}


def step_flops(cfg: dict, tokens, raw, atoms, coords) -> float:
    d, n, v = cfg["n_hidden_xformer"], cfg["n_layer_xformer"], cfg["n_tok"]
    dec = (np.asarray(tokens) > 0).sum(1)  # decoder rows are packed before their [PAD]s
    enc = flops.live_length(np.asarray(raw), cfg["stop_token"])
    real, pairs = flops.live_geometry(np.asarray(atoms), np.asarray(coords), cfg["egnn_cutoff"])
    fwd = flops.trunk_flops(enc, d, n) + flops.trunk_flops(dec, d, n) + 2.0 * d * v * dec.sum()
    fwd += flops.egnn_flops(real, pairs, cfg["n_hidden_e3nn"], cfg["n_layer_e3gnn"])
    fwd += len(dec) * 3 * flops.head_flops(cfg)
    return 3.0 * fwd


def traced(ctx, state, record):
    """The steps after the window, profiled inside the trainer's loop; the
    wall they are held against is as many of the window's steps."""
    pipe = state.pipe
    steps = ctx.traffic["traced_steps"]
    k4 = 0.0
    for atoms, coords in pipe.traced_batches:
        real, pairs = flops.live_geometry(np.asarray(atoms), np.asarray(coords),
                                          ctx.cfg["egnn_cutoff"])
        a = np.asarray(atoms) > 0
        real_pairs = int((a.sum(1) ** 2).sum())
        k4 += ctx.cfg["n_layer_e3gnn"] * kernels.k4_s(pairs, real, real_pairs,
                                                        ctx.cfg["n_hidden_e3nn"])
    wall = steps * record["window_s"] / record["steps"]
    record.update({"traced_steps": steps, "traced_wall_s": wall, "k4_needed_s": k4})
    return pipe.trace, wall


def release(ctx, state):
    state.model = None
    torch.cuda.empty_cache() if torch.device(ctx.device).type == "cuda" else None


_ATOM = re.compile(r"\[(\d*)([A-Z][a-z]?|[a-z]{1,2})[^\]]*\]|Br|Cl|[BCNOPSFI]|[bcnops]")
_Z = {"B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Si": 14, "P": 15, "S": 16, "Cl": 17, "Se": 34,
      "Br": 35, "I": 53}


def heavy_atoms(text: str) -> Counter:
    """Heavy atoms of SMILES text by atomic number (-1 for a symbol it does
    not know); hydrogens left out."""
    out = Counter()
    for m in _ATOM.finditer(text):
        symbol = m.group(2) if m.group(0).startswith("[") else m.group(0)
        if symbol != "H":
            out[_Z.get(symbol[0].upper() + symbol[1:], -1)] += 1
    return out


def _device_batch(b, device):
    out = {k: torch.as_tensor(b[k], dtype=torch.long, device=device)
           for k in ("raw_tokens", "tokens", "y_next", "atoms")}
    out["coords"] = torch.as_tensor(b["coords"], dtype=torch.float32, device=device)
    return out


def picks(state, batches):
    """The clip-token choice of each row, which the recipe fixes:
    `p_clip_emb_smi` 0, every row takes its point embedding's token (the
    program draws a uniform a row and compares it with 0), 1 every row its
    SMILES embedding's."""
    p = state.config.p_clip_emb_smi
    if p not in (0.0, 1.0):
        raise ValueError(f"p_clip_emb_smi {p}: the check follows the clip-token choice only "
                         "where the recipe fixes it (0 or 1)")
    return [torch.full((b["tokens"].shape[0], 1), p == 0.0, device=b["tokens"].device)
            for b in batches]


def _opt(state) -> dict:
    return {"lr": state.config.lr, "weight_decay": state.config.weight_decay,
            "clip_grad": state.config.clip_grad, "betas": (0.9, 0.99), "eps": 1e-8}


def reference_run(ctx, state, q=None, fault=None):
    """The start: three steps from the seeded weights."""
    w0 = weights.seeded(ctx.cfg, ctx.seed, ctx.device)
    batches = [_device_batch(b, ctx.device) for b in state.pipe.first]
    ref = train_steps(w0, ctx.cfg, _opt(state), batches, picks(state, batches),
                      q or checks.EXACT, fault)
    return w0, ref


def window_reference(ctx, state, q=None, fault=None):
    """The followed window step, from the program's parameters and Adam's
    moments before it."""
    h, names = state.hooks.window, state.names

    def tree(leaves):
        return weights.from_port({names[i]: x for i, x in leaves.items()}, ctx.cfg)

    p0 = tree(h["before"])
    batch = [_device_batch(state.pipe.window_batch, ctx.device)]
    ref = train_steps(p0, ctx.cfg, _opt(state), batch, picks(state, batch), q or checks.EXACT,
                      fault, moments=(tree(h["m"]), tree(h["v"])),
                      steps_before=state.pipe.window_step)
    return p0, ref


def program_readings(ctx, state):
    """The program's loss, first gradient, parameters before and change
    over the followed steps of the start, by parameter name."""
    h = state.hooks
    names = state.names
    grad = {names[i]: m / (1 - h.beta1) for i, m in h.first_moment.items()}
    before = {names[i]: p for i, p in h.before.items()}
    delta = {names[i]: h.after[i] - p for i, p in h.before.items()}
    return state.losses, grad, before, delta


def window_program_readings(state):
    """The same for the followed window step: its gradient as the
    optimizer got it is (m_after - beta1 m_before) / (1 - beta1)."""
    h, names, b1 = state.hooks.window, state.names, state.hooks.beta1
    grad = {names[i]: (h["m_after"][i] - b1 * m) / (1 - b1) for i, m in h["m"].items()}
    before = {names[i]: p for i, p in h["before"].items()}
    delta = {names[i]: h["after"][i] - p for i, p in h["before"].items()}
    return [state.window_loss], grad, before, delta


def numbers(readings, w0, ref) -> dict:
    losses, grad, before, delta = readings
    ref_grad = weights.port_leaves(ref["first_grad"])
    moved = checks.moved_leaves(ref_grad)
    ref_delta = weights.port_leaves(_sub(ref["params"], w0))
    ref_losses = [x[0] for x in ref["losses"]]
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    g = checks.leaf_gaps(grad, ref_grad)
    d = checks.leaf_gaps(delta, ref_delta, moved)
    start = checks.leaf_gaps(before, weights.port_leaves(w0))
    return {
        "loss_gap": max(loss), "loss_gap_step1": loss[0], "loss_gaps": loss,
        "grad_gap": max(g.values()), "grad_gap_median": float(np.median(list(g.values()))),
        "grad_worst_leaf": max(g, key=g.get),
        "change_gap": max(d.values()), "change_gap_median": float(np.median(list(d.values()))),
        "change_worst_leaf": max(d, key=d.get),
        "start_gap": max(start.values()),
    }


def _sub(a, b):
    if isinstance(a, dict):
        return {k: _sub(a[k], b[k]) for k in a}
    return a - b


def transform_rows_wrong(ctx, state) -> int:
    """Rows of the followed batches (the start's and the window step's)
    whose transform is wrong: next-token labels that are not the decoder
    tokens shifted by one with [CLIP], [PAD], [UNK], [SUFFIX] and [MIDDLE]
    masked to -1; or a target SMILES or a decoder row (its special tokens
    left out, a fill-in-the-middle row put back in order) whose heavy
    atoms, element by element, are not its molecule's."""
    vocab = Vocabulary(ctx.cfg["vocab"])
    keys = {i: k for k, i in vocab.ids.items()}
    n_special = len(vocab.special)
    masked = [vocab.ids[t] for t in ("[CLIP]", "[PAD]", "[UNK]", "[SUFFIX]", "[MIDDLE]")]

    suffix, middle = vocab.ids["[SUFFIX]"], vocab.ids["[MIDDLE]"]

    def atoms_of(row):
        # a fill-in-the-middle row, A [SUFFIX] C [MIDDLE] B, is the text A B C
        ids = [int(t) for t in row]
        if suffix in ids and middle in ids:
            s, m = ids.index(suffix), ids.index(middle)
            ids = ids[:s] + ids[m + 1:] + ids[s + 1: m]
        return heavy_atoms("".join(keys[t] for t in ids if t >= n_special))

    wrong = 0
    for b in state.pipe.first + [state.pipe.window_batch]:
        tokens = np.asarray(b["tokens"])
        want = np.zeros_like(tokens)
        want[:, :-1] = tokens[:, 1:]
        want[np.isin(want, masked)] = -1
        for row, raw, labels, expect, atoms in zip(tokens, b["raw_tokens"], b["y_next"], want,
                                                   b["atoms"]):
            molecule = Counter(int(a) for a in atoms if a > 1)
            wrong += not (np.array_equal(labels, expect) and atoms_of(raw) == molecule
                          and atoms_of(row) == molecule)
    return wrong


_WINDOW_KEYS = ("loss_gap", "grad_gap", "grad_gap_median", "grad_worst_leaf", "change_gap",
                "change_gap_median", "change_worst_leaf")


def readings(ctx, state, q=None, fault=None):
    """The numbers `correct` can compare: the start's and, prefixed
    `window_`, the followed window step's. With a precision `q` or a
    planted `fault` the reference so computed stands in for the program
    (the control, or the fault's reading)."""
    w0, ref = reference_run(ctx, state)
    p0, wref = window_reference(ctx, state)
    if q is None and fault is None:
        got, wgot = program_readings(ctx, state), window_program_readings(state)
    else:
        got = _as_readings(w0, reference_run(ctx, state, q, fault)[1])
        wgot = _as_readings(p0, window_reference(ctx, state, q, fault)[1])
    out = numbers(got, w0, ref)
    window = numbers(wgot, p0, wref)
    out.update({f"window_{k}": window[k] for k in _WINDOW_KEYS})
    out.update(transform_rows_wrong=transform_rows_wrong(ctx, state),
               window_step=state.pipe.window_step)
    return out


def _as_readings(w0, run):
    """A reference run read as the program's readings."""
    grad = weights.port_leaves(run["first_grad"])
    delta = weights.port_leaves(_sub(run["params"], w0))
    return [x[0] for x in run["losses"]], grad, weights.port_leaves(w0), delta
