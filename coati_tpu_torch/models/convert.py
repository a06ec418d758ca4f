"""Weights carried into the port.

Two sources, one target: the port's `CoatiModel` (and `Coati2Model`),
whose state-dict keys and (out, in) weight layout are the reference's.

  * `state_from_coati_tpu` turns the JAX package's parameters, as the
    nested dict of numpy arrays its documents hold (coati_tpu
    models/io.py params_to_state), into that flat state dict: linear
    weights are transposed from (in, out) and layer stacks are split per
    layer, exactly as coati_tpu's export_coati would name them.
  * `gradients_from_coati_tpu` carries a JAX gradient pytree the same way,
    so that gradients compare name by name.
  * `load_reference_state_dict` loads a reference-format flat state dict
    (torch tensors or numpy arrays, optional 'module.' prefixes) strictly.
  * For COATI2: `coati2_state_from_coati_tpu` carries coati_tpu's
    Coati2Params (or their gradients), and `convert_coati2` loads a
    reference COATI_Smiles_Inference state dict.
  * `due_from_coati_tpu` carries a coati_tpu DUE model (its parameters as
    numpy and its config) into the port's DueModel.
  * `moe_from_coati_tpu` carries coati_tpu's MoeParams (parallel/ep.py).
  * Sharded states: `split_state` / `merge_states` for tensor parallelism,
    `stage_state` / `merge_stage_states` for pipeline stages.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from coati_tpu_torch.models.coati import CoatiConfig, CoatiModel
from coati_tpu_torch.models.coati2 import Coati2Config, Coati2Model
from coati_tpu_torch.models.mla_moe import MlaMoeConfig

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
    "mla",
)


def config_from_model_kwargs(model_kwargs: Mapping[str, object], **overrides) -> CoatiConfig:
    """CoatiConfig from a document's stored constructor kwargs."""
    kwargs = {k: model_kwargs[k] for k in _COATI_KWARG_FIELDS if k in model_kwargs}
    kwargs.update(overrides)
    if isinstance(kwargs.get("mla"), Mapping):  # the latent-attention trunk's widths
        kwargs["mla"] = MlaMoeConfig(**kwargs["mla"])
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


def load_reference_state_dict(model: torch.nn.Module, state_dict: Mapping[str, object]):
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


# ------------------------------------------------------------------ COATI2

_COATI2_KWARG_FIELDS = (
    "n_layer_xformer",
    "n_hidden_xformer",
    "embed_dim",
    "n_head",
    "n_seq",
    "mlp_dropout",
    "enc_to_coati",
    "n_direct_clr",
    "n_tok",
    "biases",
)


def coati2_config_from_model_kwargs(model_kwargs: Mapping[str, object], **overrides) -> Coati2Config:
    """Coati2Config from a document's stored constructor kwargs."""
    kwargs = {k: model_kwargs[k] for k in _COATI2_KWARG_FIELDS if k in model_kwargs}
    kwargs.update(overrides)
    return Coati2Config(**kwargs)


def _swiglu_state(p: Mapping, prefix: str, idx=(0, 2, 4)) -> Dict[str, torch.Tensor]:
    """coati_tpu SwigluResnetParams -> LayerNorm, Linear, Linear at the
    given Sequential indices under `prefix`."""
    ln, fc, out = idx
    return {
        f"{prefix}.{ln}.weight": _tensor(p["ln_scale"]),
        f"{prefix}.{ln}.bias": _tensor(p["ln_bias"]),
        f"{prefix}.{fc}.weight": _lin(p["w1"]),
        f"{prefix}.{fc}.bias": _tensor(p["b1"]),
        f"{prefix}.{out}.weight": _lin(p["w2"]),
        f"{prefix}.{out}.bias": _tensor(p["b2"]),
    }


def coati2_state_from_coati_tpu(
    nested: Mapping, enc_to_coati: str = "swiglu_resnet"
) -> Dict[str, torch.Tensor]:
    """coati_tpu Coati2Params (the nested numpy dict of params_to_state) ->
    the flat state dict of a Coati2Model. A linear smiles_to_coati head is
    recognized by its fields; `enc_to_coati` tells the two SwiGLU heads
    apart, whose fields are the same. Carries a gradient pytree alike."""
    sd = {f"xformer.{k}": v for k, v in transformer_state_from_coati_tpu(nested["xformer"]).items()}
    head = nested["smiles_to_coati"]
    if "w" in head:  # ProjLinearParams: Sequential(LayerNorm, Linear)
        sd.update(_projection_state(head, False, "smiles_to_coati"))
    elif enc_to_coati == "swiglu_mlp":  # Sequential(LN, Linear, SwiGLU, Linear)
        sd.update(_swiglu_state(head, "smiles_to_coati", (0, 1, 3)))
    elif enc_to_coati == "swiglu_resnet":
        sd.update(_swiglu_state(head, "smiles_to_coati.net"))
    else:
        raise ValueError(f"enc_to_coati {enc_to_coati!r} does not fit a SwiGLU head")
    sd.update(_swiglu_state(nested["coati_to_token"], "coati_to_token.net"))
    return sd


def convert_coati2(state_dict: Mapping[str, object], cfg: Coati2Config) -> Coati2Model:
    """A reference COATI_Smiles_Inference state dict (simple_coati2) loaded
    strictly into a Coati2Model."""
    return load_reference_state_dict(Coati2Model(cfg), state_dict)


# -------------------------------------------------------------------- LoRA


def lora_from_coati_tpu(lora):
    """coati_tpu's LoraParams (numpy or JAX leaves under a / b, with rank
    and alpha) -> the port's LoraParams. Both keep A as (L, in, r) and B as
    (L, r, out) under the same target names, so nothing is transposed."""
    from coati_tpu_torch.training.finetune import LoraParams

    return LoraParams({k: _tensor(v).float() for k, v in lora.a.items()},
                      {k: _tensor(v).float() for k, v in lora.b.items()},
                      rank=int(lora.rank), alpha=float(lora.alpha))


# --------------------------------------------------------------------- DUE


def due_from_coati_tpu(params_as_numpy, config_dict: Mapping[str, object], device=None):
    """coati_tpu's DueParams with numpy (or JAX) leaves, as its DueModel.save
    pickles them (`net` with first_w (in, out), first_b, res_w (depth, in,
    out), res_b, u_first, u_res; `gp` with inducing, var_mean, var_chol and
    the log scales), and its config's fields -> the port's DueModel on
    `device` (the card unless the CPU is named). Weights are transposed to
    (out, in); nested dicts of the same names are taken too."""
    from coati_tpu_torch.common.util import resolve_device
    from coati_tpu_torch.regression.due import DueConfig, DueModel, empty_params

    def get(obj, name, default=None):
        if isinstance(obj, Mapping):
            return obj.get(name, default)
        return getattr(obj, name, default)

    net, gp = get(params_as_numpy, "net"), get(params_as_numpy, "gp")
    config = DueConfig(**dict(config_dict))
    state = {
        "net.first.weight": _lin(get(net, "first_w")),
        "net.first.bias": _tensor(get(net, "first_b")),
        "net.u_first": _tensor(get(net, "u_first")),
        "net.u_res": _tensor(get(net, "u_res")),
        "gp.mean_const": _tensor(get(gp, "mean_const", np.zeros((), np.float32))),
    }
    for name in ("inducing", "var_mean", "var_chol", "log_lengthscale", "log_outputscale",
                 "log_noise"):
        state["gp." + name] = _tensor(get(gp, name))
    for i, (w, b) in enumerate(zip(np.asarray(get(net, "res_w")), np.asarray(get(net, "res_b")))):
        state[f"net.res.{i}.weight"] = _lin(w)
        state[f"net.res.{i}.bias"] = _tensor(b)
    params = empty_params(config)
    params.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return DueModel(params.to(resolve_device(device)), config)


# ---------------------------------------------------------------- sharding


def split_tensor(full: torch.Tensor, dim: int, rank: int, n: int, qkv: bool = False) -> torch.Tensor:
    """Rank `rank`'s shard of `full` among n: the rank-th of n equal pieces
    along `dim`. qkv: a fused (3 D, ...) q | k | v projection, split within
    each third, so that a shard holds the same heads of q, k and v."""
    if qkv:
        if dim != 0:
            raise ValueError("a fused qkv projection splits along dim 0")
        thirds = full.reshape((3, n, full.shape[0] // (3 * n)) + tuple(full.shape[1:]))
        return thirds[:, rank].reshape((-1,) + tuple(full.shape[1:])).contiguous()
    return full.chunk(n, dim)[rank].contiguous()


def merge_tensors(parts, dim: int, qkv: bool = False) -> torch.Tensor:
    """The inverse of split_tensor over the n shards, in rank order."""
    if qkv:
        n = len(parts)
        per = parts[0].shape[0] // 3
        stacked = torch.stack([p.reshape((3, per) + tuple(p.shape[1:])) for p in parts], dim=1)
        return stacked.reshape((3 * n * per,) + tuple(parts[0].shape[1:]))
    return torch.cat(list(parts), dim=dim)


def split_state(state: Mapping[str, torch.Tensor], specs: Mapping[str, object], rank: int,
                n: int) -> Dict[str, torch.Tensor]:
    """A full state dict -> rank `rank`'s shards. `specs` maps a key to None
    (replicated) or to an object with `dim` and `qkv` (parallel/tp.py's
    ShardSpec); keys it lacks are replicated."""
    out = {}
    for k, v in state.items():
        spec = specs.get(k)
        out[k] = v if spec is None else split_tensor(v, spec.dim, rank, n, spec.qkv)
    return out


def merge_states(states, specs: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """Every rank's shards (state dicts in rank order) -> the full state dict
    in the reference layout."""
    out = {}
    for k, v in states[0].items():
        spec = specs.get(k)
        out[k] = v if spec is None else merge_tensors([s[k] for s in states], spec.dim, spec.qkv)
    return out


def moe_from_coati_tpu(moe, device=None):
    """coati_tpu's MoeParams (router (D, E), w_fc (E, D, F), b_fc (E, F),
    w_out (E, F, D), b_out (E, D); numpy or JAX leaves) -> the port's
    MoeParams module on `device` (the card unless the caller names
    another). Both packages keep the einsum layout, so nothing is
    transposed."""
    from coati_tpu_torch.common.util import resolve_device
    from coati_tpu_torch.parallel.ep import MoeParams

    get = (lambda k: moe[k]) if isinstance(moe, Mapping) else (lambda k: getattr(moe, k))
    params = MoeParams(*(_tensor(get(k)).float() for k in MoeParams.FIELDS))
    return params.to(resolve_device(device))


_BLOCK_KEY = re.compile(r"(?:^|\.)transformer\.h\.(\d+)\.")


def layer_index(key: str) -> Optional[int]:
    """The trunk layer a state-dict key belongs to, or None."""
    m = _BLOCK_KEY.search(key)
    return None if m is None else int(m.group(1))


def stage_state(state: Mapping[str, torch.Tensor], n_layer: int, n_stages: int,
                stage: int) -> Dict[str, torch.Tensor]:
    """A whole trunk's or COATI's state dict -> pipeline stage `stage`'s:
    the replicated keys and the blocks of layers [s L / S, (s + 1) L / S)
    (parallel/pp.py pp_param_specs), under their own keys."""
    per = n_layer // n_stages
    return {k: v for k, v in state.items()
            if layer_index(k) is None or layer_index(k) // per == stage}


def merge_stage_states(states) -> Dict[str, torch.Tensor]:
    """The inverse of stage_state over every stage's state (in stage order):
    the whole state dict, the replicated keys taken from stage 0, in the
    single-device key order (by layer, then as stage 0 lists them)."""
    merged = dict(states[0])
    for s in states[1:]:
        merged.update({k: v for k, v in s.items() if layer_index(k) is not None})
    # the single-device order: keys before the blocks, the blocks by layer,
    # then the keys after them (ln_f, lm_head, ...), as in a whole model
    keys = list(states[0])
    first_block = next((j for j, k in enumerate(keys) if layer_index(k) is not None), len(keys))
    head = [(k, merged[k]) for k in keys[:first_block]]
    blocks = sorted(((k, v) for k, v in merged.items() if layer_index(k) is not None),
                    key=lambda kv: layer_index(kv[0]))
    tail = [(k, merged[k]) for k in keys[first_block:] if layer_index(k) is None]
    return dict(head + blocks + tail)
