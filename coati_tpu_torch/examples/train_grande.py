"""Grande pretraining launcher (the reference's
examples/training/train_grande.py).

One process a card. On one card it runs as is; over several, start it
with torchrun and --multihost: each process then joins the process group
that torchrun's environment describes (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and trains its share of the data mesh on
cuda:LOCAL_RANK.

Usage:
    python -m coati_tpu_torch.examples.train_grande --data_dir ./COATI_data [--dry_run]
    torchrun --nproc_per_node 4 -m coati_tpu_torch.examples.train_grande \
        --data_dir ./COATI_data --multihost
"""

from __future__ import annotations

import argparse

import numpy as np

from coati_tpu_torch.examples import DEVICE_HELP
from coati_tpu_torch.training.config import grande_config
from coati_tpu_torch.training.logger import COATILogger
from coati_tpu_torch.training.train import train_autoencoder


def distributed_mesh(multihost: bool):
    """(mesh, is_main): the data mesh over torchrun's ranks with
    --multihost, else (None, True)."""
    if not multihost:
        return None, True
    import torch.distributed as dist

    from coati_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    return mesh, dist.get_rank() == 0


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="COATI grande pretraining")
    parser.add_argument("--data_dir", type=str, default="./")
    parser.add_argument("--output_dir", type=str, default="./logs/")
    parser.add_argument("--model_dir", type=str, default="./model_ckpts/")
    parser.add_argument("--resume_document", type=str, default=None)
    parser.add_argument("--dry_run", action="store_true",
                        help="synthetic one-epoch smoke run without the 340GB corpus")
    parser.add_argument("--multihost", action="store_true",
                        help="join the torch.distributed group torchrun describes")
    parser.add_argument("--n_epochs", type=int, default=None,
                        help="epochs to run (default: the recipe's 25)")
    parser.add_argument("--max_steps_per_epoch", type=int, default=None,
                        help="stop each epoch after this many steps")
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    mesh, is_main = distributed_mesh(args.multihost)
    config = grande_config(
        data_dir=args.data_dir,
        output_dir=args.output_dir,
        model_dir=args.model_dir,
        resume_document=args.resume_document,
    )

    if args.n_epochs is not None:
        config.n_epochs = args.n_epochs

    logger = None
    if is_main:
        logger = COATILogger(
            model_name="e3gnn_smiles_clip_e2e",
            output_path=config.output_dir,
            model_path=config.model_dir,
            args=config.as_dict(),
            dataset="",
        )
        logger.start()

    if args.dry_run:
        dataset = SyntheticDataset()
        config.n_epochs = 1
        config.batch_size = 8
        max_steps = args.max_steps_per_epoch or 4
    else:
        from coati_tpu_torch.data.dataset import COATI_dataset

        dataset = COATI_dataset(cache_dir=config.data_dir)
        max_steps = args.max_steps_per_epoch
    model, results = train_autoencoder(config, dataset, device=args.device, logger=logger,
                                       max_steps_per_epoch=max_steps, mesh=mesh)
    if logger is not None:
        logger.stop()
    print("training complete;", results["best_test"])
    return {"model": model, "results": results, "config": config}


class SyntheticDataset:
    """Tiny random-SMILES corpus for smoke runs."""

    summary = {"dataset_type": "synthetic"}

    def get_data_pipe(self, batch_size=8, partition="train", required_fields=(),
                      xform_routine=lambda x: x, **kw):
        from coati_tpu_torch.data.batch_pipe import batch_rows

        rng = np.random.default_rng(0)
        frags = ["C", "CC", "CCO", "c1ccccc1", "CCN", "CC(=O)O", "CCCC"]

        def rows():
            for i in range(batch_size * 8):
                smi = frags[i % len(frags)]
                n = max(1, len(smi))
                yield {
                    "smiles": smi,
                    "source_collection": "geom_drugs",
                    "atoms": rng.integers(1, 9, size=(n,)).astype(np.float64),
                    "coords": rng.normal(size=(n, 3)),
                }

        return batch_rows(
            rows(), batch_size=batch_size, partition="raw",
            xform_routine=xform_routine, required_fields=["smiles"],
        )


if __name__ == "__main__":
    main()
