"""Model-document IO.

A model document is a pickled dict {train_args, dataset_summary, model,
optimizer, model_kwargs, ...}. Two formats of `model` load:

  * coati_tpu's own: a nested dict of numpy arrays (what coati_tpu's
    params_to_state writes, e.g. docs/eval_model_r5.pkl);
  * the reference's: a flat state dict with dotted keys, of torch tensors
    (decoded onto the CPU) or numpy arrays.

Both become the port's CoatiModel (or, through `load_coati2`, its
Coati2Model) on the requested device. The port's own training checkpoints
(`serialize_model`) are written in the second format, with numpy arrays,
which both packages' loaders read.
"""

from __future__ import annotations

import pickle
from io import BytesIO
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from coati_tpu_torch.common.util import resolve_device
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.coati2 import COATI2
from coati_tpu_torch.models.convert import (
    coati2_config_from_model_kwargs,
    coati2_state_from_coati_tpu,
    config_from_model_kwargs,
    convert_coati2,
    model_from_state,
    projection_is_old_architecture,
    state_from_coati_tpu,
    strip_module_prefix,
)
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer


class _TorchCpuUnpickler(pickle.Unpickler):
    """Unpickle torch-tensor payloads onto the CPU."""

    def find_class(self, module, name):
        if module == "torch.storage" and name == "_load_from_bytes":
            return lambda b: torch.load(BytesIO(b), map_location="cpu", weights_only=False)
        return super().find_class(module, name)


def load_model_doc(path: str) -> dict:
    """Load a model document from a local path."""
    with open(path, "rb") as f:
        return _TorchCpuUnpickler(f, encoding="UTF-8").load()


def load_e3gnn_smiles_clip_e2e(
    doc_url: Union[str, dict],
    device=None,
    freeze: bool = True,
    strict: bool = False,
    old_architecture: Optional[bool] = None,
    override_args: Optional[dict] = None,
    model_type: str = "default",
    print_debug: bool = False,
) -> Tuple[COATI, TrieTokenizer]:
    """Load a COATI model document (a path, or the loaded dict) ->
    (COATI, TrieTokenizer), on `device`: the CUDA card unless the caller
    names another; with no card and no device this raises.

    Signature of the reference loader; `strict` is accepted for it (the
    port always loads strictly). `old_architecture` is detected from the
    projection-head layer order of a flat state dict when not given."""
    del strict
    device = resolve_device(device)
    if model_type not in ("default", "fp"):
        raise ValueError(f"unknown model type {model_type!r}")
    doc = doc_url if isinstance(doc_url, dict) else load_model_doc(doc_url)
    model_kwargs = dict(doc["model_kwargs"])
    if override_args:
        model_kwargs.update(override_args)

    sd = strip_module_prefix(doc["model"])
    if any("." in k for k in sd):  # reference-format flat state dict
        if old_architecture is None:
            old_architecture = projection_is_old_architecture(sd, "smiles_to_clip")
    else:  # coati_tpu-format nested numpy dict
        sd = state_from_coati_tpu(sd, old_architecture=bool(old_architecture))
    cfg = config_from_model_kwargs(model_kwargs, old_architecture=bool(old_architecture))
    model, cfg = model_from_state(cfg, sd)
    model = model.to(device)
    if freeze:
        model.requires_grad_(False)
    model.eval()

    tokenizer_vocab = doc["train_args"]["tokenizer_vocab"]
    tokenizer = TrieTokenizer(n_seq=cfg.n_seq, **get_vocab(tokenizer_vocab))
    if "selfies" in tokenizer_vocab:
        # SELFIES documents (e.g. the published selfies_barlow) rebind
        # pre_tokenize to encode SMILES to SELFIES first (reference
        # io/coati.py:90-92)
        from coati_tpu_torch.tokenizers.selfies_support import to_selfies_tokenizer

        tokenizer = to_selfies_tokenizer(tokenizer)
    if print_debug:
        print("NTokens: ", doc.get("n_toks_processed"))
        print("Model kwargs: ", model_kwargs)
    return COATI(model, cfg), tokenizer


def coati2_state_from_document(doc: dict, enc_to_coati: str) -> Dict[str, torch.Tensor]:
    """A COATI2 document's model as the port's flat state dict: the
    reference's (and the port's own) flat dotted keys as they are, or
    coati_tpu's nested Coati2Params carried across."""
    sd = strip_module_prefix(doc["model"])
    if any("." in k for k in sd):
        return sd
    return coati2_state_from_coati_tpu(sd, enc_to_coati)


def load_coati2(
    doc_url: Union[str, dict],
    device=None,
    freeze: bool = True,
    old_architecture: bool = False,
    force_cpu: bool = False,
) -> Tuple[COATI2, TrieTokenizer]:
    """Load a COATI2 model document (a path, or the loaded dict) ->
    (COATI2, TrieTokenizer), on `device`: the CUDA card unless the caller
    names another (force_cpu names the CPU); with no card and no device
    this raises. Signature of the reference loader
    (simple_coati2/io.py:21-84); `old_architecture` is accepted for it and
    has no COATI2 meaning."""
    del old_architecture
    device = resolve_device("cpu" if force_cpu else device)
    doc = doc_url if isinstance(doc_url, dict) else load_model_doc(doc_url)
    cfg = coati2_config_from_model_kwargs(doc["model_kwargs"])
    model = convert_coati2(coati2_state_from_document(doc, cfg.enc_to_coati), cfg).to(device)
    if freeze:
        model.requires_grad_(False)
    model.eval()
    tokenizer = TrieTokenizer(n_seq=cfg.n_seq, **get_vocab(doc["train_args"]["tokenizer_vocab"]))
    return COATI2(model, cfg), tokenizer


def load_offline_loss(doc_url: str):
    """The loss curves a training run stored in its document."""
    print("Loading Loss from offline training")
    return load_model_doc(doc_url)["offline_loss"]


# ------------------------------------------------------- our checkpoints


def model_to_state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The model's state dict as numpy arrays under the reference's dotted
    keys (pickle-friendly, and free of any torch payload)."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def serialize_model(
    train_args: dict,
    dataset_summary: dict,
    model_state: dict,
    model_kwargs: dict,
    optimizer_state=None,
    **kwargs,
) -> bytes:
    """Build a model-document blob in the reference's envelope; extra
    keywords (n_toks_processed, n_grads_processed, offline_loss) are stored
    beside the fixed ones."""
    doc = {
        "train_args": train_args,
        "dataset_summary": dataset_summary,
        "model": model_state,
        "optimizer": optimizer_state,
        "model_kwargs": model_kwargs,
        **kwargs,
    }
    blob = pickle.dumps(doc, protocol=pickle.HIGHEST_PROTOCOL)
    print("Model Document size (MB): ", len(blob) / (1024 * 1024))
    return blob
