"""COATI2 pretraining launcher: the reconstructed training recipe
(coati_tpu_torch/training/train_coati2.py), property-token-conditioned AR
plus directCLR over two SMILES writings, on the coati2_12_12 vocabulary.
Several cards: torchrun and --multihost, as train_grande.

Usage:
    python -m coati_tpu_torch.examples.train_coati2 --data_dir ./COATI_data [--dry_run]
"""

from __future__ import annotations

import argparse

from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.examples.train_grande import SyntheticDataset, distributed_mesh
from coati_tpu_torch.training.logger import COATILogger
from coati_tpu_torch.training.train_coati2 import Coati2TrainConfig, train_coati2


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="COATI2 pretraining")
    parser.add_argument("--data_dir", type=str, default="./")
    parser.add_argument("--output_dir", type=str, default="./logs/")
    parser.add_argument("--model_dir", type=str, default="./model_ckpts/")
    parser.add_argument("--resume_document", type=str, default=None)
    parser.add_argument("--orbax_dir", type=str, default=None,
                        help="restart checkpoints here; resume from the latest")
    parser.add_argument("--dry_run", action="store_true",
                        help="synthetic one-epoch smoke run")
    parser.add_argument("--multihost", action="store_true",
                        help="join the torch.distributed group torchrun describes")
    parser.add_argument("--n_epochs", type=int, default=None,
                        help="epochs to run (default: the recipe's 25)")
    parser.add_argument("--max_steps_per_epoch", type=int, default=None,
                        help="stop each epoch after this many steps")
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    mesh, is_main = distributed_mesh(args.multihost)
    # COATI2 grande: 512-d embedding, SwiGLU-resnet heads
    config = Coati2TrainConfig(
        n_layer_xformer=16,
        n_hidden_xformer=512,
        embed_dim=512,
        n_head=16,
        n_seq=128,
        enc_to_coati="swiglu_resnet",
        n_direct_clr=64,
        batch_size=160,
        lr=5e-4,
        n_epochs=25,
        output_dir=args.output_dir,
        resume_document=args.resume_document,
        orbax_dir=args.orbax_dir,
    )

    if args.n_epochs is not None:
        config.n_epochs = args.n_epochs

    logger = None
    if is_main:
        logger = COATILogger(
            model_name="coati2",
            output_path=config.output_dir,
            model_path=args.model_dir,
            args=config.as_dict(),
            dataset="",
        )
        logger.start()

    if args.dry_run:
        config.n_epochs = 1
        config.batch_size = 8
        config.n_layer_xformer = 2
        config.n_hidden_xformer = 64
        config.embed_dim = 64
        config.n_head = 4
        dataset = SyntheticDataset()
        max_steps = args.max_steps_per_epoch or 4
    else:
        from coati_tpu_torch.data.dataset import COATI_dataset

        dataset = COATI_dataset(cache_dir=args.data_dir)
        max_steps = args.max_steps_per_epoch
    model, results = train_coati2(config, dataset, device=args.device, logger=logger,
                                  max_steps_per_epoch=max_steps, mesh=mesh)
    if logger is not None:
        logger.stop()
    print("training complete;", {k: results[k] for k in ("best_test", "best_epoch")})
    return {"model": model, "results": results, "config": config}


if __name__ == "__main__":
    main()
