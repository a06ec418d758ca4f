"""Training configuration.

Own copy of coati_tpu/training/config.py: a dataclass with the field names
of the reference argparse schema, so params.json files and checkpoint
train_args round-trip between the two packages. `parallel_mode` and
`param_sharding` choose the multi-device step and placement
(training/train.py, parallel/placement.py)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class TrainConfig:
    exp_name: str = "token_transformer"
    run_name: str = ""
    output_dir: str = "COATI_outputs"
    model_dir: str = "COATI_models"
    data_dir: str = "COATI_data"

    dtype: str = "float32"  # compute dtype ("float32" | "bfloat16")
    log_batch_loss: int = 25
    n_epochs: int = 2
    batch_size: int = 32  # per-device batch size (reference: per-GPU)

    recipe: List[dict] = field(
        default_factory=lambda: [
            {"collection": "geom_drugs", "n_samples": 6_000_000, "filter": {}}
        ]
    )

    n_layer_e3gnn: int = 4
    n_hidden_e3nn: int = 128
    msg_cutoff_e3nn: float = 10.0
    n_hidden_xformer: int = 128
    n_embd_common: int = 128
    n_layer_xformer: int = 16
    n_head: int = 8
    biases: bool = True
    n_seq: int = 200  # max length during training
    max_n_seq: int = 250  # max length the model can forward
    tokenizer_vocab: str = "mar"
    torch_emb: bool = False
    load_transformer_only: bool = False

    p_dataset: float = 0.3
    p_formula: float = 0.3
    p_fim: float = 0.5
    p_graph: float = 0.3
    p_clip: float = 0.3
    p_clip_cut: float = 0.3
    p_clip_emb_smi: float = 0.4
    p_randsmiles: float = 0.5

    norm_clips: bool = False
    token_mlp: bool = False
    norm_embed: bool = False
    # EGNN backward rematerialization. True is the safe default (bounds
    # the dense path's (B, N, N, H) peak); grande turns it off, since the
    # fused message kernels never materialize that tensor
    egnn_remat: bool = True
    # transformer-trunk backward rematerialization, per block; grande
    # turns it on
    xformer_remat: bool = False
    # training-attention softmax dtype of the JAX package. The port's
    # attention kernels always take the softmax in float32, so the field
    # is carried for the round trip only
    softmax_dtype: str = "float32"
    weight_decay: float = 0.1
    lr: float = 4e-4
    clip_grad: float = 10.0
    # linear per-step LR warmup over this many steps (0 = off, the
    # reference recipe). Used by the small-corpus eval recipes, where a
    # full-lr first step overshoots the InfoNCE init saddle (see the
    # warmup comment in training/train.py).
    lr_warmup_steps: int = 0
    do_clip: bool = True

    test_frac: float = 0.02
    valid_frac: float = 0.02
    test_interval: int = 1
    log_interval: int = 100
    ngrad_to_save: float = 2e6

    resume_document: Optional[str] = None
    resume_optimizer: bool = False
    # restart checkpoints: a directory of torch.save files (<step>.pt, the
    # float32 master state dict, the optimizer's state and the loop's
    # counters; training/checkpoints.py), written at the document cadence
    # and at the end of a run. A run over a directory that holds one
    # resumes from its latest. The name is coati_tpu's, whose checkpoints
    # are orbax's, so that its configs load unchanged
    orbax_dir: Optional[str] = None

    # the multi-device step over a mesh: "pjit" (the gradient of the
    # global-batch loss) | "shard_map" (per-rank AR means, DDP's semantics);
    # and the placement: "auto" (replicated, or tensor-parallel on a mesh
    # with a model axis) | "replicated" | "fsdp". One device ignores both
    parallel_mode: str = "pjit"
    param_sharding: str = "auto"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def grande_config(**overrides) -> TrainConfig:
    """The 'grande' pretraining recipe of the reference
    (examples/training/train_grande.py)."""
    cfg = TrainConfig(
        test_frac=0.02,
        valid_frac=0.0,
        n_layer_e3gnn=5,
        n_hidden_e3nn=256,
        msg_cutoff_e3nn=12.0,
        n_hidden_xformer=256,
        n_embd_common=256,
        n_layer_xformer=16,
        n_head=16,
        max_n_seq=250,
        n_seq=80,
        biases=True,
        torch_emb=False,
        norm_clips=True,
        norm_embed=False,
        token_mlp=True,
        tokenizer_vocab="mar",
        p_dataset=0.2,
        p_formula=0.0,
        p_fim=0.0,
        p_graph=0.0,
        p_clip=0.9,
        p_clip_emb_smi=0.5,
        p_randsmiles=0.3,
        batch_size=160,
        lr=5.0e-4,
        weight_decay=0.1,
        n_epochs=25,
        clip_grad=10.0,
        test_interval=2,
        ngrad_to_save=2e6,
        egnn_remat=False,
        xformer_remat=True,
        softmax_dtype="compute",  # no effect in the port, see TrainConfig
    )
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
