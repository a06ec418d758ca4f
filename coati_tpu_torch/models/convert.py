"""Weights carried into the port.

Two sources, one target: the port's `CoatiModel`, whose state-dict keys
and (out, in) weight layout are the reference's.

  * `state_from_coati_tpu` turns the JAX package's parameters, as the
    nested dict of numpy arrays its documents hold (coati_tpu
    models/io.py params_to_state), into that flat state dict: linear
    weights are transposed from (in, out) and layer stacks are split per
    layer, exactly as coati_tpu's export_coati would name them.
  * `gradients_from_coati_tpu` carries a JAX gradient pytree the same way,
    so that gradients compare name by name.
  * `load_reference_state_dict` loads a reference-format flat state dict
    (torch tensors or numpy arrays, optional 'module.' prefixes) strictly.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from coati_tpu_torch.models.coati import CoatiConfig, CoatiModel

_COATI_KWARG_FIELDS = (
    "n_layer_e3gnn",
    "n_layer_xformer",
    "n_hidden_xformer",
    "n_hidden_e3nn",
    "msg_cutoff_e3nn",
    "n_embd_common",
    "n_head",
    "n_seq",
    "n_tok",
    "biases",
    "torch_emb",
    "residual",
    "norm_clips",
    "norm_embed",
    "token_mlp",
    "use_point_encoder",
    "old_architecture",
)


def config_from_model_kwargs(model_kwargs: Mapping[str, object], **overrides) -> CoatiConfig:
    """CoatiConfig from a document's stored constructor kwargs."""
    kwargs = {k: model_kwargs[k] for k in _COATI_KWARG_FIELDS if k in model_kwargs}
    kwargs.update(overrides)
    return CoatiConfig(**kwargs)


def strip_module_prefix(state_dict: Mapping[str, object]) -> Dict[str, object]:
    """Remove DistributedDataParallel 'module.' prefixes."""
    return {
        (k[len("module.") :] if k.startswith("module.") else k): v
        for k, v in state_dict.items()
    }


def projection_is_old_architecture(sd: Mapping[str, object], prefix: str) -> bool:
    """Old-architecture heads put the Linear (2-D weight) first."""
    key = f"{prefix}.0.weight"
    return key in sd and len(sd[key].shape) == 2


def fp_map_from_keys(sd: Mapping[str, object]) -> Optional[tuple]:
    """Fingerprint heads ('fp_networks.{name}.weight') and their widths."""
    heads = sorted(
        (k.split(".")[1], int(v.shape[0]))
        for k, v in sd.items()
        if k.startswith("fp_networks.") and k.endswith(".weight")
    )
    return tuple(heads) or None


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.tensor(np.asarray(x))


def _lin(x) -> torch.Tensor:
    """(in, out) JAX weight -> (out, in)."""
    return _tensor(np.asarray(x).T)


def transformer_state_from_coati_tpu(p: Mapping) -> Dict[str, torch.Tensor]:
    """coati_tpu transformer parameters (nested numpy) -> the state dict of
    a SmilesTransformer."""
    sd: Dict[str, torch.Tensor] = {}
    if p.get("norm_embed_scale") is None:
        sd["emb.tok_emb.weight"] = _tensor(p["tok_emb"])
    else:
        sd["emb.tok_emb.0.weight"] = _tensor(p["tok_emb"])
        sd["emb.tok_emb.1.weight"] = _tensor(p["norm_embed_scale"])
        sd["emb.tok_emb.1.bias"] = _tensor(p["norm_embed_bias"])
    blocks = p["blocks"]
    names = (  # (JAX field, reference key, is a linear weight)
        ("ln1_scale", "ln_1.weight", False),
        ("ln1_bias", "ln_1.bias", False),
        ("w_attn", "attn.c_attn.weight", True),
        ("b_attn", "attn.c_attn.bias", False),
        ("w_proj", "attn.c_proj.weight", True),
        ("b_proj", "attn.c_proj.bias", False),
        ("ln2_scale", "ln_2.weight", False),
        ("ln2_bias", "ln_2.bias", False),
        ("w_fc", "mlpf.0.weight", True),
        ("b_fc", "mlpf.0.bias", False),
        ("w_out", "mlpf.2.weight", True),
        ("b_out", "mlpf.2.bias", False),
    )
    for field, key, is_weight in names:
        stack = blocks.get(field)
        if stack is None:  # biases=False
            continue
        for i, layer in enumerate(np.asarray(stack)):
            sd[f"transformer.h.{i}.{key}"] = _lin(layer) if is_weight else _tensor(layer)
    sd["transformer.ln_f.weight"] = _tensor(p["lnf_scale"])
    sd["transformer.ln_f.bias"] = _tensor(p["lnf_bias"])
    sd["lm_head.weight"] = _lin(p["lm_head"])
    return sd


def _egnn_state(p: Mapping) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    if p.get("embed_b") is None:  # torch_emb: an nn.Embedding table
        sd["emb.weight"] = _tensor(p["embed_w"])
    else:
        sd["embedding.weight"] = _lin(p["embed_w"])
        sd["embedding.bias"] = _tensor(p["embed_b"])
    layers = p["layers"]
    names = (
        ("edge_w1", "edge_mlp.0.weight", True),
        ("edge_b1", "edge_mlp.0.bias", False),
        ("edge_w2", "edge_mlp.3.weight", True),
        ("edge_b2", "edge_mlp.3.bias", False),
        ("node_w1", "node_mlp.0.weight", True),
        ("node_b1", "node_mlp.0.bias", False),
        ("node_w2", "node_mlp.3.weight", True),
        ("node_b2", "node_mlp.3.bias", False),
        ("coord_w1", "coord_mlp.0.weight", True),
        ("coord_b1", "coord_mlp.0.bias", False),
        ("coord_w2", "coord_mlp.2.weight", True),
    )
    for field, key, is_weight in names:
        for i, layer in enumerate(np.asarray(layers[field])):
            sd[f"gcl_{i}.{key}"] = _lin(layer) if is_weight else _tensor(layer)
    sd["node_dec.0.weight"] = _lin(p["dec_w1"])
    sd["node_dec.0.bias"] = _tensor(p["dec_b1"])
    sd["node_dec.3.weight"] = _lin(p["dec_w2"])
    sd["node_dec.3.bias"] = _tensor(p["dec_b2"])
    return sd


def _projection_state(p: Mapping, old_architecture: bool, prefix: str) -> Dict[str, torch.Tensor]:
    if p.get("ln_scale") is None:
        return {f"{prefix}.weight": _lin(p["w"]), f"{prefix}.bias": _tensor(p["b"])}
    lin_idx, ln_idx = (0, 1) if old_architecture else (1, 0)
    return {
        f"{prefix}.{lin_idx}.weight": _lin(p["w"]),
        f"{prefix}.{lin_idx}.bias": _tensor(p["b"]),
        f"{prefix}.{ln_idx}.weight": _tensor(p["ln_scale"]),
        f"{prefix}.{ln_idx}.bias": _tensor(p["ln_bias"]),
    }


def state_from_coati_tpu(nested: Mapping, old_architecture: bool = False) -> Dict[str, torch.Tensor]:
    """coati_tpu nested parameters (numpy) -> the port's flat state dict.
    `old_architecture` fixes the layer order of the projection heads, which
    the nested format does not record."""
    sd = {f"xformer.{k}": v for k, v in transformer_state_from_coati_tpu(nested["xformer"]).items()}
    if nested.get("point_encoder") is not None:
        sd.update({f"point_encoder.{k}": v for k, v in _egnn_state(nested["point_encoder"]).items()})
        sd.update(_projection_state(nested["point_to_clip"], old_architecture, "point_to_clip"))
    sd.update(_projection_state(nested["smiles_to_clip"], old_architecture, "smiles_to_clip"))
    if nested.get("token_w") is not None:
        sd["point_clip_to_special_tokens.1.weight"] = _lin(nested["token_w"])
        sd["point_clip_to_special_tokens.1.bias"] = _tensor(nested["token_b"])
    for name, head in sorted((nested.get("fp_heads") or {}).items()):
        sd[f"fp_networks.{name}.weight"] = _lin(head["w"])
        sd[f"fp_networks.{name}.bias"] = _tensor(head["b"])
    return sd


def gradients_from_coati_tpu(
    nested: Mapping, old_architecture: bool = False
) -> Dict[str, torch.Tensor]:
    """A coati_tpu gradient pytree (nested numpy, the structure of the
    parameters) under the port's parameter names and layouts. The map of
    `state_from_coati_tpu` only transposes and unstacks, so it carries a
    gradient exactly as it carries the parameter."""
    return state_from_coati_tpu(nested, old_architecture)


def load_reference_state_dict(model: CoatiModel, state_dict: Mapping[str, object]) -> CoatiModel:
    """Load a reference-format flat state dict into `model`, strictly."""
    sd = {k: _tensor(v) for k, v in strip_module_prefix(state_dict).items()}
    model.load_state_dict(sd, strict=True)
    return model


def model_from_state(cfg: CoatiConfig, state_dict: Mapping[str, object]):
    """(CoatiModel, config) for a flat state dict, loaded strictly. Parts
    the dict lacks (point encoder, fingerprint heads) are left out of the
    model and its config, as coati_tpu's converter leaves them out."""
    sd = strip_module_prefix(state_dict)
    cfg = cfg.replace(
        use_point_encoder=cfg.use_point_encoder and any(k.startswith("point_encoder.") for k in sd),
        fp_map=fp_map_from_keys(sd),
    )
    return load_reference_state_dict(CoatiModel(cfg), sd), cfg
