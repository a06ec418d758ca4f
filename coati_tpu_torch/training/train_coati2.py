"""COATI2 pretraining: directCLR + property-conditioned AR, on one device
or over a mesh.

PyTorch counterpart of coati_tpu/training/train_coati2.py. On one device
the step is the "pjit" formulation of coati_tpu's, in which the directCLR
loss spans the whole batch; over a mesh (`mesh=`) both formulations run as
in training/train.py, the directCLR loss over every rank's h1, h2 and bad
rows (all-gathered, the gather's backward summing), and the placement of
`param_sharding` (replicated, tensor-parallel on a model axis, where the
coati2_12_12 vocabulary of 4,266 splits, or fully-sharded) owns the
optimizer.

  * loss = ar_loss + directCLR(h_canonical, h_permuted) * log2(vocab), the
    directCLR term over the first `n_direct_clr` embedding dims
    (models/coati2.py direct_clr_loss);
  * rows from coati2_ar_xform (data/xform_coati2.py): property-token
    blocks of the coati2_12_12 vocabulary, [CLIP][UNK] injection prefixes,
    permuted second views;
  * the optimizer, schedule and metric reads of training/train.py
    (ClippedAdamW, cosine_lr per epoch, DeferredMetrics);
  * checkpoints are COATI2 model documents with the model as the flat
    reference state dict of numpy arrays, which load_coati2 reads; with
    `orbax_dir`, restart checkpoints as train_autoencoder writes them, with
    coati_tpu's three counters (n_toks, epoch, global_step).

Every full-sequence attention of the port is a kernel. Where coati_tpu
pins its plain attention for training, the port takes the short-sequence
pair (K5f forward, K5b backward) when n_seq <= 128, as
model_config_from_train_config does for COATI, and else K2, whose backward
replays the plain attention. coati_tpu's recipe takes the softmax in the
compute dtype (softmax_dtype "compute"); the port's kernels keep it in
float32, so the two agree in float32 and not bit for bit under bfloat16.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coati_tpu_torch.common import tracing
from coati_tpu_torch.data.xform_coati2 import coati2_ar_xform
from coati_tpu_torch.models import coati2 as C2
from coati_tpu_torch.models.coati2 import Coati2Config, Coati2Model
from coati_tpu_torch.models.convert import load_reference_state_dict
from coati_tpu_torch.models.io import (
    coati2_state_from_document,
    load_model_doc,
    serialize_model,
)
from coati_tpu_torch.ops.kernels.packed_attention import MAX_T as PACKED_MAX_T
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from coati_tpu_torch.training.checkpoints import CheckpointManager
from coati_tpu_torch.training.diagnostics import step_timer
from coati_tpu_torch.training.flops import coati2_train_step_model_flops
from coati_tpu_torch.training.logger import COATILogger
from coati_tpu_torch.training.train import (
    ClippedAdamW,
    DeferredMetrics,
    MeshRun,
    ParallelStep,
    _state_numpy,
    cosine_lr,
    full_training_state,
    make_epoch_metrics_processor,
    make_optimizer,
    restore_restart,
    save_restart,
    set_learning_rate,
)

BATCH_KEYS = ("tokens", "raw_tokens", "rand_tokens", "y_next")


@dataclass
class Coati2TrainConfig:
    """Field names and defaults of coati_tpu's Coati2TrainConfig."""

    exp_name: str = "coati2"
    run_name: str = ""
    output_dir: str = "COATI_outputs"

    dtype: str = "float32"
    n_epochs: int = 2
    batch_size: int = 32

    # model (COATI2 grande: 512-d embedding, SwiGLU heads, README.md:23)
    n_layer_xformer: int = 16
    n_hidden_xformer: int = 256
    embed_dim: int = 256
    n_head: int = 16
    n_seq: int = 128
    enc_to_coati: str = "swiglu_resnet"
    n_direct_clr: int = 64
    biases: bool = True
    tokenizer_vocab: str = "coati2_12_12"

    # data recipe (coati2_ar_xform)
    p_props: float = 0.5
    p_prop_each: float = 0.5
    p_clip: float = 0.9
    p_dataset: float = 0.2

    # objective
    clr_inv_temp: float = 10.0
    do_clr: bool = True
    remat: bool = True  # recompute each transformer block in the backward
    # the JAX package's softmax dtype for training attention; the port's
    # kernels always take it in float32
    softmax_dtype: str = "compute"

    # optimizer (reference COATI1 values, train_coati.py:145-152)
    lr: float = 4e-4
    weight_decay: float = 0.1
    clip_grad: float = 10.0

    log_batch_loss: int = 25
    log_interval: int = 100
    test_interval: int = 1
    ngrad_to_save: float = 2e6
    resume_document: Optional[str] = None
    # restart checkpoints (torch.save files; see TrainConfig.orbax_dir)
    orbax_dir: Optional[str] = None
    # the multi-device step and placement over a mesh (see TrainConfig)
    parallel_mode: str = "pjit"
    param_sharding: str = "auto"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def model_config(self, n_tok: int) -> Coati2Config:
        packed = self.n_seq <= PACKED_MAX_T and self.n_head > 1
        return Coati2Config(
            n_layer_xformer=self.n_layer_xformer,
            n_hidden_xformer=self.n_hidden_xformer,
            embed_dim=self.embed_dim,
            n_head=self.n_head,
            n_seq=self.n_seq,
            enc_to_coati=self.enc_to_coati,
            n_direct_clr=self.n_direct_clr,
            n_tok=n_tok,
            biases=self.biases,
            dtype=self.dtype,
            remat=self.remat,
            softmax_dtype=self.softmax_dtype,
            prefill_kernel="packed" if packed else "auto",
        )

    def model_kwargs(self, n_tok: int) -> dict:
        """Document model_kwargs: the fields load_coati2 reads."""
        return {
            "n_layer_xformer": self.n_layer_xformer,
            "n_hidden_xformer": self.n_hidden_xformer,
            "embed_dim": self.embed_dim,
            "n_head": self.n_head,
            "n_seq": self.n_seq,
            "enc_to_coati": self.enc_to_coati,
            "n_direct_clr": self.n_direct_clr,
            "n_tok": n_tok,
            "biases": self.biases,
        }


class Coati2TrainStep:
    """One step of the COATI2 trainer: forward, the two losses, backward,
    clip, AdamW. Calling it runs the whole step and returns the metrics as
    0-d tensors on the device; `losses` and `update` are its two halves.
    With is_training=False the call only evaluates. Over a mesh `parallel`
    (training/train.py ParallelStep) carries the collectives."""

    def __init__(
        self,
        model: Coati2Model,
        model_cfg: Coati2Config,
        optimizer: Optional[ClippedAdamW],
        *,
        stop_token: int,
        unk_token: int,
        pad_token: int,
        token_entropy_unit: float,
        do_clr: bool = True,
        clr_inv_temp: float = 10.0,
        is_training: bool = True,
        parallel: Optional[ParallelStep] = None,
    ):
        self.model = model
        self.model_cfg = model_cfg
        self.optimizer = optimizer
        self.stop_token = stop_token
        self.unk_token = unk_token
        self.pad_token = pad_token
        self.token_entropy_unit = token_entropy_unit
        self.do_clr = do_clr
        self.clr_inv_temp = clr_inv_temp
        self.is_training = is_training
        self.parallel = parallel or ParallelStep()

    def losses(self, batch: Dict[str, torch.Tensor]):
        """(loss, ar_loss, clr_loss) of a batch of device tensors; float32
        scalars attached to the graph."""
        h1, h2, logits, bad_rows = C2.coati2_training_forward(
            self.model, self.model_cfg, batch["tokens"], batch["raw_tokens"],
            batch["rand_tokens"], self.stop_token, self.unk_token, self.pad_token,
        )
        ar = self.parallel.ar_loss(logits, batch["y_next"])
        if not self.do_clr:
            return ar, ar, torch.zeros((), device=ar.device)
        h1, h2, bad_rows = self.parallel.rows(h1, h2, bad_rows)
        cl = C2.direct_clr_loss(h1, h2, bad_rows, self.model_cfg.n_direct_clr, self.clr_inv_temp)
        return ar + cl * self.token_entropy_unit, ar, cl

    def update(self) -> None:
        """Reduce the gradients over the mesh, clip them, step the optimizer,
        drop the gradients."""
        self.parallel.update(self.optimizer)

    def __call__(self, batch: Dict[str, torch.Tensor]):
        self.parallel.before_forward()
        if self.is_training:
            loss, ar, cl = self.losses(batch)
            loss.backward()
            self.update()
        else:
            with torch.no_grad():
                loss, ar, cl = self.losses(batch)
        return self.parallel.metrics(loss, ar, cl)


def make_coati2_train_step(model, model_cfg, optimizer, **kwargs) -> Coati2TrainStep:
    """The step of train_coati2; see Coati2TrainStep for the keywords."""
    return Coati2TrainStep(model, model_cfg, optimizer, **kwargs)


def batch_to_device(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The four model inputs of a transformed host batch, on the device."""
    return {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.long).to(device, non_blocking=True)
            for k in BATCH_KEYS}


def fresh_model(model_cfg: Coati2Config, device: torch.device, seed: int = 0) -> Coati2Model:
    """A Coati2Model with PyTorch's default initialisation drawn from
    `seed`, without touching the global random state."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = Coati2Model(model_cfg)
    return model.to(device)


def train_coati2(
    config: Coati2TrainConfig,
    dataset,
    device=None,
    logger: Optional[COATILogger] = None,
    max_steps_per_epoch: Optional[int] = None,
    seed: int = 0,
    mesh=None,
) -> Tuple[Coati2Model, dict]:
    """COATI2 pretraining loop. `dataset` exposes get_data_pipe(...) like
    COATI_dataset; rows need only a 'smiles' column (plus optional
    precomputed 'properties' / 'rand_smiles' / flag columns). Runs on
    `device`: the CUDA card unless the caller names another; with no card
    and no device this raises. With `mesh` this is one rank of a
    multi-device run, as train_autoencoder's. The transform draws from the
    global `random` module, as coati_tpu's does. With config.orbax_dir,
    restart checkpoints are written there and the run resumes from the
    latest. Returns (model, results), the model whole on every rank;
    results["history"] holds (partition, epoch, step, loss, ar_loss,
    clr_loss) per step and results["train_step_seconds"] the host seconds
    of each training step."""
    run = MeshRun(mesh, device)
    device = run.device

    tokenizer = TrieTokenizer(n_seq=config.n_seq, **get_vocab(config.tokenizer_vocab))
    token_entropy_unit = float(np.log2(tokenizer.n_token))
    model_cfg = config.model_config(tokenizer.n_token)
    model_kwargs = config.model_kwargs(tokenizer.n_token)

    model = fresh_model(model_cfg, device, seed)
    n_toks = 0
    ngrad_updates = 0
    offline_losses = {"batch_losses": [], "ar_losses": [], "clip_losses": []}
    if config.resume_document is not None:
        doc = load_model_doc(config.resume_document)
        n_toks = doc.get("n_toks_processed", 0)
        load_reference_state_dict(model, coati2_state_from_document(doc, config.enc_to_coati))
        print("Loaded from checkpoint. ")
    model.train()
    placement = run.placement(model, config)
    optimizer = placement.optimizer if placement is not None else make_optimizer(config, model)
    start_epoch = 0
    global_step = 0
    ckpt_mgr = None
    if config.orbax_dir:
        ckpt_mgr = CheckpointManager(config.orbax_dir)
        counters = restore_restart(ckpt_mgr, model, optimizer, 3, placement)
        if counters is not None:
            n_toks, start_epoch, global_step = counters
            if run.is_main:
                print(f"Resumed from restart step {ckpt_mgr.latest_step()} "
                      f"(epoch {start_epoch})")

    step_kwargs = dict(
        stop_token=tokenizer.stop_token, unk_token=tokenizer.unk_token,
        pad_token=tokenizer.pad_token, token_entropy_unit=token_entropy_unit,
        do_clr=config.do_clr, clr_inv_temp=config.clr_inv_temp,
        parallel=ParallelStep(placement, config.parallel_mode),
    )
    step_train = make_coati2_train_step(model, model_cfg, optimizer, is_training=True,
                                        **step_kwargs)
    step_eval = make_coati2_train_step(model, model_cfg, optimizer, is_training=False,
                                       **step_kwargs)

    def xform_routine(batch):
        with tracing.span("train.xform"):
            return coati2_ar_xform(
                batch, tokenizer=tokenizer, p_props=config.p_props,
                p_prop_each=config.p_prop_each, p_clip=config.p_clip, p_dataset=config.p_dataset,
            )

    results = {"epochs": [], "losses": [], "best_test": 1e10, "best_epoch": 0,
               "history": [], "train_step_seconds": []}

    def save(epoch: int, tags: dict) -> None:
        """The document (main rank) and the restart checkpoint, from one
        gathered state."""
        state = full_training_state(model, optimizer, placement)
        if run.is_main and logger is not None:
            logger.log_model_document(serialize_model(
                train_args=config.as_dict(),
                dataset_summary=getattr(dataset, "summary", {}),
                model_state=_state_numpy(state[0]),
                model_kwargs=model_kwargs,
                optimizer_state=None,
                n_toks_processed=n_toks,
                n_grads_processed=ngrad_updates,
                offline_loss=offline_losses,
            ), tags=tags)
        save_restart(ckpt_mgr, global_step, model, optimizer, [n_toks, epoch, global_step],
                     placement, run.is_main, state)

    def do_epoch(epoch: int, partition: str) -> Optional[float]:
        nonlocal n_toks, ngrad_updates, global_step
        timer = step_timer()
        t0 = time.time()
        loss_arr, ng = [], 0
        total_model_flops = 0.0
        pipe = dataset.get_data_pipe(
            batch_size=config.batch_size,
            partition=partition,
            required_fields=["smiles"],
            xform_routine=xform_routine,
            **run.pipe_kwargs(),
        )
        totals = {"loss": 0.0, "count": 0}
        process_metrics = make_epoch_metrics_processor(
            config=config, logger=logger, offline_losses=offline_losses,
            partition=partition, epoch=epoch, totals=totals,
            get_counters=lambda: (n_toks, ng, t0),
            clip_metric="clr_loss", clip_label="clr_l", loss_arr=loss_arr,
            is_main=run.is_main,
        )
        dm = DeferredMetrics(process_metrics)
        batches = run.batches(pipe, lambda b: batch_to_device(b, device),
                              dict.fromkeys(BATCH_KEYS, torch.long),
                              lambda b: int((b["tokens"] != tokenizer.pad_token).sum()))
        for i, (batch, device_batch, rows, tokens) in enumerate(batches):
            if max_steps_per_epoch is not None and i >= max_steps_per_epoch:
                break
            bsz, seq = device_batch["tokens"].shape
            if partition == "train":
                total_model_flops += coati2_train_step_model_flops(
                    n_layer_xformer=config.n_layer_xformer,
                    n_hidden_xformer=config.n_hidden_xformer,
                    n_tok=tokenizer.n_token, batch=bsz, seq=seq,
                )
            with timer, tracing.span("train.step"):
                if not dm.sync:
                    # drain the previous step only now (its device work
                    # overlapped this batch's host transform and transfer)
                    dm.drain()
                if partition == "train":
                    with tracing.span("train.forward_backward"):
                        metrics = step_train(device_batch)
                    global_step += 1
                else:
                    metrics = step_eval(device_batch)
                if dm.sync:
                    dm.push(i, metrics, bsz)
            if not dm.sync:
                dm.push(i, metrics, bsz)
            if partition == "train":
                ngrad_updates += rows
                ng += rows
                n_toks += tokens
                if ngrad_updates > config.ngrad_to_save:
                    ngrad_updates = 0
                    save(epoch, {"train_epoch": str(epoch)})
        dm.drain()
        results["history"].extend(
            (partition, epoch, j, *values) for j, values in enumerate(loss_arr))
        if partition == "train":
            results["train_step_seconds"].extend(timer.times)
        if totals["count"] == 0:
            return None
        if run.is_main and logger is not None:
            stats = timer.emit()
            if partition == "train" and total_model_flops:
                stats["model_tflops_per_sec_per_chip"] = (
                    total_model_flops / max(time.time() - t0, 1e-9) / 1e12
                )
            logger.log_metrics(
                {f"{partition}_{k}": v for k, v in stats.items()}, dataset_epoch=epoch
            )
        return totals["loss"] / totals["count"]

    for epoch in range(start_epoch, config.n_epochs):
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
            if run.is_main:
                print(f"test loss: {test_loss:.4f} \t epoch {epoch}")

    save(config.n_epochs, {"best": "best"})
    if ckpt_mgr is not None:
        ckpt_mgr.wait()
        ckpt_mgr.close()
    if placement is not None:
        model = placement.gathered_model()
    return model, results
