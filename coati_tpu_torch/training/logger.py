"""JSON-lines metric and artifact logger.

Own copy of coati_tpu/training/logger.py (the reference's COATILogger). The
JSONL event schema is load-bearing: offline_loss entries produced by
log_metric are stored inside checkpoints and re-plotted by the loader."""

from __future__ import annotations

import json
import os
import socket
from contextlib import contextmanager
from typing import Any, Dict, List

from coati_tpu_torch.common.util import makedir, utc_epoch_now


class COATILogger:
    def __init__(
        self,
        model_name: str,
        output_path: str,
        model_path: str,
        tags: List[str] = [],
        run_time=None,
        dataset: str = None,
        args: Dict[str, Any] = None,
    ):
        self._running = False
        self.output_path = output_path
        self.model_path = model_path
        self.model_name = model_name
        self.tags = tags
        self.run_time = run_time
        self.args = args
        self.dataset = dataset

    def start(self):
        self._running = True
        if self.run_time is None:
            self.run_time = str(int(utc_epoch_now()))
        self.run_host = socket.gethostname()
        makedir(os.path.join(self.output_path, self.run_time))
        self.log_file = os.path.join(self.output_path, self.run_time, "log.json")
        with open(self.log_file, "w") as f:
            f.write("[")

    def stop(self, failed: bool = False, details: str = None):
        self._running = False
        with open(self.log_file, "a") as f:
            f.write("]")

    def _append(self, event: Dict[str, Any]):
        with open(self.log_file, "a") as f:
            f.write(json.dumps(event) + ",")

    def log_metric(
        self,
        key: str,
        value: Any,
        dataset_epoch: int = None,
        step: int = None,
        tags: Dict[str, str] = None,
    ) -> Dict[str, Any]:
        event = {
            "event": "metric",
            "epoch": str(int(utc_epoch_now())),
            "run_time": self.run_time,
            "model_name": self.model_name,
            "key": key,
            "value": value,
        }
        if dataset_epoch is not None:
            event["dataset_epoch"] = dataset_epoch
        if step is not None:
            event["step"] = step
        if tags is not None:
            event.update({f"tag_{k}": v for k, v in tags.items()})
        self._append(event)
        return event

    def log_metrics(self, metrics: Dict[str, Any], **kwargs):
        for key, val in metrics.items():
            self.log_metric(key, val, **kwargs)

    def log_epoch_stats(self, epoch_stats, tags=None):
        if not self._running:
            raise RuntimeError("Please save predictions before ending the run.")
        epoch = str(int(utc_epoch_now()))
        suffix = f"epoch_stats/{self.model_name}_{self.run_time}_{epoch}"
        event = {
            "event": "epoch_stats",
            "epoch": epoch,
            "run_time": self.run_time,
            "model_name": self.model_name,
            "document": os.path.join(self.output_path, suffix),
        }
        if tags is not None:
            event.update({f"tag_{k}": v for k, v in tags.items()})
        self._append(event)

    def get_model_path(self, name, run_time, epoch):
        return os.path.join(self.model_path, f"{name}_{run_time}_{epoch}")

    def log_model_document(self, blob: bytes, tags: Dict[str, str] = None) -> str:
        """Write a serialized model document to the model path (the
        reference's log_pytorch)."""
        print(f"Logging model run_time {self.run_time}")
        epoch = str(int(utc_epoch_now()))
        url = self.get_model_path(self.model_name, self.run_time, epoch)
        makedir(url, isfile=True)
        with open(url, "wb") as f:
            f.write(blob)
        print("Logged Artifact to:", url)
        return url

    # reference-compatible alias
    log_pytorch = log_model_document


@contextmanager
def coati_logger(*args, **kwargs):
    logger = COATILogger(*args, **kwargs)
    logger.start()
    try:
        yield logger
    except Exception as ex:
        logger.stop(failed=True, details=str(ex))
        raise
    else:
        logger.stop()
