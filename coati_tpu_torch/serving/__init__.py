"""Serving: micro-batched inference over the COATI surfaces (batcher.py),
the continuous-batching decode engine (continuous.py) and the HTTP server
(server.py). Counterpart of coati_tpu/serving."""

from coati_tpu_torch.serving.batcher import MicroBatcher
from coati_tpu_torch.serving.continuous import ContinuousDecoder, ContinuousService
from coati_tpu_torch.serving.server import CoatiInferenceServer

__all__ = ["ContinuousDecoder", "ContinuousService", "MicroBatcher", "CoatiInferenceServer"]
