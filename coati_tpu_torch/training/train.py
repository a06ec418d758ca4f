"""CLIP + autoregressive pretraining on one device.

PyTorch counterpart of coati_tpu/training/train.py (itself the reference's
DDP loop), single device: the "pjit" formulation of its train step, in which
the CLIP loss spans the whole batch and the autoregressive loss is averaged
over all valid tokens of the batch.

  * AdamW (betas 0.9/0.99, eps 1e-8, weight decay on every parameter, as
    optax's unmasked adamw) after a global-norm clip, cosine-annealed per
    epoch;
  * loss = ar_loss + clip_loss * log2(vocab);
  * bf16 compute keeps float32 master weights, gradients and moments; both
    cross-entropies are taken in float32;
  * checkpoints are model documents with the reference envelope (train_args
    / model_kwargs / offline_loss / token counters), the model as the flat
    reference state dict of numpy arrays, which both packages' loaders read.

PyTorch modules and optimizers hold their state, so where the JAX step maps
(params, opt_state, rng, batch) to new ones, `TrainStep` updates the model
and the optimizer it was built with, and draws from the generator it is
given. Multi-device training and restart checkpoints (`orbax_dir`) are not
ported yet and raise.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coati_tpu_torch.common.util import makedir, resolve_device
from coati_tpu_torch.data.xform import clip_ar_xform
from coati_tpu_torch.models import coati as F
from coati_tpu_torch.models.coati import CoatiConfig, CoatiModel
from coati_tpu_torch.models.convert import state_from_coati_tpu, strip_module_prefix
from coati_tpu_torch.models.io import load_model_doc, model_to_state, serialize_model
from coati_tpu_torch.ops.kernels.packed_attention import MAX_T as PACKED_MAX_T
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training.config import TrainConfig
from coati_tpu_torch.training.diagnostics import step_timer
from coati_tpu_torch.training.flops import coati_train_step_model_flops
from coati_tpu_torch.training.logger import COATILogger


class ClippedAdamW(torch.optim.AdamW):
    """AdamW after a global-norm clip of the gradients: what the JAX package
    builds as optax.chain(clip_by_global_norm, adamw). The clip scales every
    gradient by clip / max(norm, clip), as optax does
    (torch.nn.utils.clip_grad_norm_ scales by clip / (norm + 1e-6))."""

    def __init__(self, params, lr: float, weight_decay: float, clip_grad: float, **kwargs):
        super().__init__(params, lr=lr, betas=(0.9, 0.99), eps=1e-8,
                         weight_decay=weight_decay, **kwargs)
        self.clip_grad = float(clip_grad)

    @torch.no_grad()
    def clip_gradients(self) -> torch.Tensor:
        """Scale the gradients in place; returns their norm before."""
        grads = [p.grad for g in self.param_groups for p in g["params"] if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip_grad / norm.clamp_min(self.clip_grad))
        return norm

    def step(self, closure=None):
        # a parameter the loss does not reach (the EGNN's coordinate MLPs)
        # still decays, as under optax, which sees a zero gradient for it;
        # torch.optim skips a parameter without a gradient altogether
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.clip_gradients()
        return super().step(closure)


def make_optimizer(config: TrainConfig, model: torch.nn.Module) -> ClippedAdamW:
    params = list(model.parameters())
    on_card = bool(params) and params[0].device.type == "cuda"
    return ClippedAdamW(params, lr=config.lr, weight_decay=config.weight_decay,
                        clip_grad=config.clip_grad, fused=on_card)


def cosine_lr(config: TrainConfig, epoch: int) -> float:
    """torch CosineAnnealingLR(T_max=n_epochs, eta_min=0) stepped per epoch."""
    return 0.5 * config.lr * (1.0 + np.cos(np.pi * epoch / config.n_epochs))


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def model_config_from_train_config(config: TrainConfig, n_tok: int) -> CoatiConfig:
    """The model a TrainConfig describes. Every full-sequence attention of
    the port is a kernel, so where the JAX package pins its plain attention
    for training, the port picks the short-sequence kernel (K5f forward,
    K5b backward) when no training batch can be longer than it takes, and
    else K2, whose backward replays the plain attention."""
    packed = config.n_seq <= PACKED_MAX_T and config.n_head > 1
    return CoatiConfig(
        n_layer_e3gnn=config.n_layer_e3gnn,
        n_layer_xformer=config.n_layer_xformer,
        n_hidden_xformer=config.n_hidden_xformer,
        n_hidden_e3nn=config.n_hidden_e3nn,
        msg_cutoff_e3nn=config.msg_cutoff_e3nn,
        n_embd_common=config.n_embd_common,
        n_head=config.n_head,
        n_seq=config.max_n_seq,
        n_tok=n_tok,
        biases=config.biases,
        torch_emb=config.torch_emb,
        norm_clips=config.norm_clips,
        norm_embed=config.norm_embed,
        token_mlp=config.token_mlp,
        use_point_encoder=config.do_clip,
        dtype=config.dtype,
        egnn_remat=config.egnn_remat,
        remat=config.xformer_remat,
        softmax_dtype=config.softmax_dtype,
        prefill_kernel="packed" if packed else "auto",
    )


class DeferredMetrics:
    """One-step-deferred metric reads for the epoch loop.

    float(metrics[...]) waits for the device; draining step i's metrics
    only after batch i+1's host transform and transfer are done lets that
    host work run under the device step. Values are unchanged, just read
    one step later. TRAIN_SYNC_METRICS=1 restores the per-step wait (push()
    then drains immediately)."""

    def __init__(self, process):
        self._process = process  # (step_idx, metrics, batch_size) -> None
        self._pending = None
        self.sync = os.environ.get("TRAIN_SYNC_METRICS") == "1"

    def drain(self):
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._process(*pending)

    def push(self, step_idx, metrics, batch_size):
        self._pending = (step_idx, metrics, batch_size)
        if self.sync:
            self.drain()


def make_epoch_metrics_processor(
    *,
    config,
    logger,
    offline_losses,
    partition: str,
    epoch: int,
    totals: dict,
    get_counters,
    clip_metric: str = "clip_loss",
    clip_label: str = "clip_l",
    log_clip: bool = True,
    loss_arr=None,
):
    """Build the (step_idx, metrics, batch_size) processor the epoch loop
    hands to DeferredMetrics: reads the three scalar losses (each read waits
    for the device), appends the JSONL offline-loss records, prints the
    periodic line, and accumulates totals["loss"]/["count"]. `get_counters`
    returns the loop's live (n_toks, ng, t0) for the log tags and rates;
    `clip_metric` and `clip_label` name the contrastive loss in the log and
    the printed line (COATI2 logs its directCLR loss as "clr_loss");
    `loss_arr` collects (loss, ar_loss, clip_loss) per step and smooths the
    printed loss over 10 steps."""

    def process(j, metrics, bsz):
        loss = float(metrics["loss"])
        ar = float(metrics["ar_loss"])
        cl = float(metrics["clip_loss"])
        n_toks, ng, t0 = get_counters()
        if logger is not None and j % config.log_batch_loss == 0:
            tags = {"n_toks": n_toks}
            records = [("batch_losses", "batch_loss", loss), ("ar_losses", "ar_loss", ar)]
            if log_clip:
                records.append(("clip_losses", clip_metric, cl))
            for store, key, value in records:
                offline_losses[store].append(
                    logger.log_metric(f"{partition}_{key}", value, dataset_epoch=epoch, step=j,
                                      tags=tags)
                )
        if j % config.log_interval == 0:
            prefix = "" if partition == "train" else f">> {partition} \t"
            recent = [x[0] for x in loss_arr[-10:]] if loss_arr else [loss]
            print(
                prefix
                + f"Epoch {epoch} \t it {j} \t toks {n_toks // 10**6}m "
                f"\t ar_l: {ar:.2f}, {clip_label} {cl:.6f}, "
                f"loss {sum(recent) / len(recent):.4f} \t "
                f"grads_ps {ng / max(time.time() - t0, 1e-6):.4f}"
            )
        totals["loss"] += loss * bsz
        totals["count"] += bsz
        if loss_arr is not None:
            loss_arr.append((loss, ar, cl))

    return process


class TrainStep:
    """One step of the single-device trainer: forward, the two losses,
    backward, clip, AdamW. Calling it runs the whole step and returns the
    metrics as 0-d tensors on the device (reading one waits for the step);
    `losses` and `update` are its two halves. With is_training=False the
    call only evaluates: the model and the optimizer are left untouched."""

    def __init__(
        self,
        model: CoatiModel,
        model_cfg: CoatiConfig,
        optimizer: Optional[ClippedAdamW],
        *,
        stop_token: int,
        unk_token: int,
        p_clip_emb_smi: float,
        token_entropy_unit: float,
        do_clip: bool,
        is_training: bool = True,
    ):
        self.model = model
        self.model_cfg = model_cfg
        self.optimizer = optimizer
        self.stop_token = stop_token
        self.unk_token = unk_token
        self.p_clip_emb_smi = p_clip_emb_smi
        self.token_entropy_unit = token_entropy_unit
        self.do_clip = do_clip
        self.is_training = is_training

    def losses(self, generator, batch: Dict[str, torch.Tensor], pick_point=None):
        """(loss, ar_loss, clip_loss) of a batch of device tensors; float32
        scalars attached to the graph."""
        h_e3gnn, h_smiles, logits, bad_rows = F.forward(
            self.model, self.model_cfg, generator,
            batch["raw_tokens"], batch["tokens"], batch["atoms"], batch["coords"],
            self.stop_token, self.unk_token, self.p_clip_emb_smi, pick_point=pick_point,
        )
        ar = F.ar_loss_fn(logits, batch["y_next"])
        if not self.do_clip:
            return ar, ar, torch.zeros((), device=ar.device)
        cl = F.clip_loss(h_smiles, h_e3gnn, bad_rows)
        return ar + cl * self.token_entropy_unit, ar, cl

    def update(self) -> None:
        """Clip the gradients, step the optimizer, drop the gradients."""
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)

    def __call__(self, generator, batch: Dict[str, torch.Tensor], pick_point=None):
        if self.is_training:
            loss, ar, cl = self.losses(generator, batch, pick_point)
            loss.backward()
            self.update()
        else:
            with torch.no_grad():
                loss, ar, cl = self.losses(generator, batch, pick_point)
        return {"loss": loss.detach(), "ar_loss": ar.detach(), "clip_loss": cl.detach()}


def make_train_step(model, model_cfg, optimizer, **kwargs) -> TrainStep:
    """The step of train_autoencoder; see TrainStep for the keywords."""
    return TrainStep(model, model_cfg, optimizer, **kwargs)


def batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The five model inputs of a transformed host batch, on the device."""
    out = {
        k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.long).to(device, non_blocking=True)
        for k in ("raw_tokens", "tokens", "y_next", "atoms")
    }
    out["coords"] = torch.as_tensor(np.asarray(batch["coords"], np.float32)).to(
        device, non_blocking=True)
    return out


def fresh_model(model_cfg: CoatiConfig, device: torch.device, seed: int = 0) -> CoatiModel:
    """A CoatiModel with PyTorch's default initialisation drawn from `seed`,
    without touching the global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CoatiModel(model_cfg)
    return model.to(device)


def _state_from_document(doc: dict) -> Dict[str, torch.Tensor]:
    """A document's model as the port's flat state dict of tensors."""
    sd = strip_module_prefix(doc["model"])
    if not any("." in k for k in sd):  # coati_tpu's nested format
        return state_from_coati_tpu(sd)
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.tensor(np.asarray(v))
            for k, v in sd.items()}


def _optimizer_state_numpy(optimizer: torch.optim.Optimizer) -> dict:
    def to_numpy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        if isinstance(x, dict):
            return {k: to_numpy(v) for k, v in x.items()}
        return x

    return to_numpy(optimizer.state_dict())


def _resume_optimizer(optimizer: torch.optim.Optimizer, saved) -> bool:
    """Load an optimizer state this trainer wrote; anything else (none, or
    the optax state of a document the JAX package wrote) is left alone."""
    if not isinstance(saved, dict) or "param_groups" not in saved or "state" not in saved:
        print("failed to resume optimizer: the document holds no optimizer state of this trainer")
        return False
    state = {
        idx: {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in s.items()}
        for idx, s in saved["state"].items()
    }
    optimizer.load_state_dict({"state": state, "param_groups": saved["param_groups"]})
    return True


def train_autoencoder(
    config: TrainConfig,
    dataset,
    device=None,
    logger: Optional[COATILogger] = None,
    max_steps_per_epoch: Optional[int] = None,
    seed: int = 0,
) -> Tuple[CoatiModel, dict]:
    """Full pretraining loop. `dataset` must expose get_data_pipe(...).
    Runs on `device`: the CUDA card unless the caller names another; with no
    card and no device this raises. Every row is canonicalized and augmented
    by clip_ar_xform as in coati_tpu, drawing from the global `random`
    module. Returns (model, results);
    results["history"] holds (partition, epoch, step, loss, ar_loss,
    clip_loss) per step and results["train_step_seconds"] the host seconds
    of each training step (a step's metrics are waited for one step later,
    so in steady state a value is a whole step)."""
    config.check_single_device()
    if config.orbax_dir:
        raise NotImplementedError(
            "orbax_dir: restart checkpoints (coati_tpu/training/checkpoints.py) are not "
            "ported yet; resume from a model document with resume_document"
        )
    device = resolve_device(device)

    if logger is not None:
        # self-describing run dir (the reference writes params.json at start)
        run_dir = os.path.join(config.output_dir, config.exp_name, config.run_name)
        makedir(run_dir)
        with open(os.path.join(run_dir, "params.json"), "w") as f:
            json.dump(config.as_dict(), f)
    tokenizer = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))
    token_entropy_unit = float(np.log(tokenizer.n_token) / np.log(2.0))

    model_cfg = model_config_from_train_config(config, tokenizer.n_token)
    model_kwargs = {
        "n_layer_xformer": config.n_layer_xformer,
        "n_layer_e3gnn": config.n_layer_e3gnn,
        "n_hidden_e3nn": config.n_hidden_e3nn,
        "n_hidden_xformer": config.n_hidden_xformer,
        "n_embd_common": config.n_embd_common,
        "biases": config.biases,
        "n_head": config.n_head,
        "n_seq": config.max_n_seq,
        "n_tok": tokenizer.n_token,
        "torch_emb": config.torch_emb,
        "norm_clips": config.norm_clips,
        "norm_embed": config.norm_embed,
        "token_mlp": config.token_mlp,
        "use_point_encoder": config.do_clip,
    }

    model = fresh_model(model_cfg, device, seed)
    n_toks = 0
    ngrad_updates = 0
    offline_losses = {"batch_losses": [], "ar_losses": [], "clip_losses": []}

    doc = None
    if config.resume_document is not None:
        doc = load_model_doc(config.resume_document)
        n_toks = doc.get("n_toks_processed", 0)
        ngrad_updates = doc.get("n_grads_processed", 0)
        loaded = _state_from_document(doc)
        if config.load_transformer_only:
            loaded = {k: v for k, v in loaded.items()
                      if k.startswith(("xformer.", "smiles_to_clip."))}
            missing, unexpected = model.load_state_dict(loaded, strict=False)
            if unexpected or any(k.startswith(("xformer.", "smiles_to_clip.")) for k in missing):
                raise ValueError(
                    f"resume_document does not fit the transformer: missing {missing}, "
                    f"unexpected {unexpected}"
                )
        else:
            model.load_state_dict(loaded, strict=True)
        print("Loaded from checkpoint. ")
    model.train()

    optimizer = make_optimizer(config, model)
    if doc is not None and config.resume_optimizer:
        _resume_optimizer(optimizer, doc.get("optimizer"))
    global_step = 0

    step_kwargs = dict(
        stop_token=tokenizer.stop_token,
        unk_token=tokenizer.unk_token,
        p_clip_emb_smi=config.p_clip_emb_smi,
        token_entropy_unit=token_entropy_unit,
        do_clip=config.do_clip,
    )
    step_train = make_train_step(model, model_cfg, optimizer, is_training=True, **step_kwargs)
    step_eval = make_train_step(model, model_cfg, optimizer, is_training=False, **step_kwargs)

    def xform_routine(batch):
        return clip_ar_xform(
            batch,
            tokenizer=tokenizer,
            p_dataset=config.p_dataset,
            p_formula=config.p_formula,
            p_fim=config.p_fim,
            p_graph=config.p_graph,
            p_clip=config.p_clip,
            p_clip_cut=config.p_clip_cut,
            p_randsmiles=config.p_randsmiles,
        )

    generator = torch.Generator(device=device).manual_seed(seed + 1)
    results = {"epochs": [], "losses": [], "best_test": 1e10, "best_epoch": 0,
               "best_params": None, "history": [], "train_step_seconds": []}

    def checkpoint(tags):
        blob = serialize_model(
            train_args=config.as_dict(),
            dataset_summary=getattr(dataset, "summary", {}),
            model_state=model_to_state(model),
            model_kwargs=model_kwargs,
            optimizer_state=_optimizer_state_numpy(optimizer),
            n_toks_processed=n_toks,
            n_grads_processed=ngrad_updates,
            offline_loss=offline_losses,
        )
        if logger is not None:
            logger.log_model_document(blob, tags=tags)

    def do_epoch(epoch: int, partition: str) -> Optional[float]:
        nonlocal n_toks, ngrad_updates, global_step
        timer = step_timer()
        t0 = time.time()
        loss_arr, ng = [], 0
        total_model_flops = 0.0  # analytic fwd+bwd FLOPs (training/flops.py)
        pipe = dataset.get_data_pipe(
            batch_size=config.batch_size,
            partition=partition,
            required_fields=["smiles"],
            xform_routine=xform_routine,
        )
        totals = {"loss": 0.0, "count": 0}
        process_metrics = make_epoch_metrics_processor(
            config=config, logger=logger, offline_losses=offline_losses,
            partition=partition, epoch=epoch, totals=totals,
            get_counters=lambda: (n_toks, ng, t0),
            log_clip=config.do_clip, loss_arr=loss_arr,
        )

        dm = DeferredMetrics(process_metrics)
        for i, batch in enumerate(pipe):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            if batch["tokens"].shape[0] != batch["atoms"].shape[0]:
                print("a row was lost, skipping batch")
                continue
            device_batch = batch_to_device(batch, device)
            bsz = batch["tokens"].shape[0]
            if (
                partition == "train"
                and config.lr_warmup_steps
                and global_step < config.lr_warmup_steps
            ):
                # linear per-step LR warmup (off by default: the reference
                # recipe has none). At init the InfoNCE embeddings sit near a
                # collapsed saddle (deep residual towers map everything to
                # almost one direction); a full-lr first step overshoots into
                # it, where the clip gradient is about zero and escape is
                # erratic.
                set_learning_rate(
                    optimizer,
                    cosine_lr(config, epoch) * (global_step + 1) / config.lr_warmup_steps,
                )
            if partition == "train":
                total_model_flops += coati_train_step_model_flops(
                    n_layer_xformer=config.n_layer_xformer,
                    n_hidden_xformer=config.n_hidden_xformer,
                    n_layer_e3gnn=config.n_layer_e3gnn,
                    n_hidden_e3nn=config.n_hidden_e3nn,
                    n_tok=tokenizer.n_token,
                    batch=bsz,
                    seq=batch["tokens"].shape[1],
                    natoms=batch["atoms"].shape[1],
                )
            with timer:
                if not dm.sync:
                    # drain the previous step only now (its device work
                    # overlapped this batch's host transform and transfer)
                    # and before queuing the next step
                    dm.drain()
                if partition == "train":
                    metrics = step_train(generator, device_batch)
                    global_step += 1
                else:
                    metrics = step_eval(generator, device_batch)
                if dm.sync:
                    dm.push(i, metrics, bsz)
            if not dm.sync:
                dm.push(i, metrics, bsz)
            if partition == "train":
                ngrad_updates += bsz
                ng += bsz
                n_toks += int((batch["tokens"] > 0).sum())
                if ngrad_updates > config.ngrad_to_save:
                    ngrad_updates = 0
                    checkpoint({"train_epoch": str(epoch), "dataset_epoch": str(epoch)})
        dm.drain()
        results["history"].extend(
            (partition, epoch, j, *values) for j, values in enumerate(loss_arr))
        if partition == "train":
            results["train_step_seconds"].extend(timer.times)
        if totals["count"] == 0:
            return None
        print(f"epoch completed in {ng} grads and {time.time() - t0} seconds")
        if logger is not None:
            logger.log_metric(
                f"{partition} epoch mean loss", totals["loss"] / totals["count"],
                dataset_epoch=epoch,
            )
            stats = timer.emit()
            if partition == "train" and total_model_flops:
                # achieved model-FLOPs throughput over the epoch wall
                # (host and checkpoint time included)
                stats["model_tflops_per_sec_per_chip"] = (
                    total_model_flops / max(time.time() - t0, 1e-9) / 1e12
                )
            logger.log_metrics(
                {f"{partition}_{k}": v for k, v in stats.items()}, dataset_epoch=epoch
            )
        return totals["loss"] / totals["count"]

    for epoch in range(config.n_epochs):
        set_learning_rate(optimizer, cosine_lr(config, epoch))
        do_epoch(epoch, "train")
        if epoch % config.test_interval == 0 and epoch > 0:
            test_loss = do_epoch(epoch, "test")
            if test_loss is None:
                continue
            results["epochs"].append(epoch)
            results["losses"].append(test_loss)
            if test_loss < results["best_test"]:
                results["best_test"] = test_loss
                results["best_epoch"] = epoch
                results["best_params"] = model_to_state(model)
            print(f"test loss: {test_loss:.4f} \t epoch {epoch}")
            print(
                f"Best: test loss: {results['best_test']:.4f} \t "
                f"epoch {results['best_epoch']}"
            )

    checkpoint({"best": "best"})
    return model, results
