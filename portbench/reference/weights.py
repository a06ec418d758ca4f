"""Weights in the stacked-layer document format, read and made here.

The format is that of the trained document `docs/eval_model_r5.pkl`: a
pickled dict whose "model" is a nested dict of float32 arrays, linear
weights in (in, out) layout and each trunk or EGNN field stacked over its
layers. `load_document` reads it onto a device. `seeded` makes the same
structure from a seed on the device, in a few large draws, with PyTorch's
default initialisation (Linear weight and bias uniform in +-1/sqrt(fan_in),
embeddings standard normal, LayerNorm scale 1 and bias 0). `document`
wraps a nested dict of arrays as a loadable document. `port_leaves` names
each leaf (one layer of a stacked field) as the program's state dict does,
so that training's per-leaf norms compare name by name; `from_port` reads
such named leaves back into the nested form.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

# (field, per-layer shape as a function of the config, kind, fan_in)
UNIFORM, NORMAL, ONES, ZEROS = "uniform", "normal", "ones", "zeros"


def _trunk_spec(cfg: dict):
    d, n_tok, n = cfg["n_hidden_xformer"], cfg["n_tok"], cfg["n_layer_xformer"]
    return [
        (("xformer", "tok_emb"), (n_tok, d), NORMAL, None),
        (("xformer", "blocks", "ln1_scale"), (n, d), ONES, None),
        (("xformer", "blocks", "ln1_bias"), (n, d), ZEROS, None),
        (("xformer", "blocks", "w_attn"), (n, d, 3 * d), UNIFORM, d),
        (("xformer", "blocks", "b_attn"), (n, 3 * d), UNIFORM, d),
        (("xformer", "blocks", "w_proj"), (n, d, d), UNIFORM, d),
        (("xformer", "blocks", "b_proj"), (n, d), UNIFORM, d),
        (("xformer", "blocks", "ln2_scale"), (n, d), ONES, None),
        (("xformer", "blocks", "ln2_bias"), (n, d), ZEROS, None),
        (("xformer", "blocks", "w_fc"), (n, d, 4 * d), UNIFORM, d),
        (("xformer", "blocks", "b_fc"), (n, 4 * d), UNIFORM, d),
        (("xformer", "blocks", "w_out"), (n, 4 * d, d), UNIFORM, 4 * d),
        (("xformer", "blocks", "b_out"), (n, d), UNIFORM, 4 * d),
        (("xformer", "lnf_scale"), (d,), ONES, None),
        (("xformer", "lnf_bias"), (d,), ZEROS, None),
        (("xformer", "lm_head"), (d, n_tok), UNIFORM, d),
    ]


def _head_spec(prefix: str, d_in: int, d_out: int):
    """LayerNorm over d_in, then Linear(d_in, d_out)."""
    return [
        ((prefix, "ln_scale"), (d_in,), ONES, None),
        ((prefix, "ln_bias"), (d_in,), ZEROS, None),
        ((prefix, "w"), (d_in, d_out), UNIFORM, d_in),
        ((prefix, "b"), (d_out,), UNIFORM, d_in),
    ]


def _swiglu_spec(prefix: str, d_in: int, d_out: int):
    return [
        ((prefix, "ln_scale"), (d_in,), ONES, None),
        ((prefix, "ln_bias"), (d_in,), ZEROS, None),
        ((prefix, "w1"), (d_in, 2 * d_out), UNIFORM, d_in),
        ((prefix, "b1"), (2 * d_out,), UNIFORM, d_in),
        ((prefix, "w2"), (d_out, d_out), UNIFORM, d_out),
        ((prefix, "b2"), (d_out,), UNIFORM, d_out),
    ]


def _egnn_spec(cfg: dict):
    h, n, n_in = cfg["n_hidden_e3nn"], cfg["n_layer_e3gnn"], 28
    pe = "point_encoder"
    return [
        ((pe, "embed_w"), (n_in, h), UNIFORM, n_in),
        ((pe, "embed_b"), (h,), UNIFORM, n_in),
        ((pe, "layers", "edge_w1"), (n, 2 * h + 1, h), UNIFORM, 2 * h + 1),
        ((pe, "layers", "edge_b1"), (n, h), UNIFORM, 2 * h + 1),
        ((pe, "layers", "edge_w2"), (n, h, h), UNIFORM, h),
        ((pe, "layers", "edge_b2"), (n, h), UNIFORM, h),
        ((pe, "layers", "node_w1"), (n, 2 * h, h), UNIFORM, 2 * h),
        ((pe, "layers", "node_b1"), (n, h), UNIFORM, 2 * h),
        ((pe, "layers", "node_w2"), (n, h, h), UNIFORM, h),
        ((pe, "layers", "node_b2"), (n, h), UNIFORM, h),
        ((pe, "layers", "coord_w1"), (n, h, h), UNIFORM, h),
        ((pe, "layers", "coord_b1"), (n, h), UNIFORM, h),
        ((pe, "layers", "coord_w2"), (n, h, 1), UNIFORM, h),
        ((pe, "dec_w1"), (h, h), UNIFORM, h),
        ((pe, "dec_b1"), (h,), UNIFORM, h),
        ((pe, "dec_w2"), (h, h), UNIFORM, h),
        ((pe, "dec_b2"), (h,), UNIFORM, h),
    ]


def spec(cfg: dict):
    """Every leaf of a configuration's model: (path, shape, kind, fan_in)."""
    out = _trunk_spec(cfg)
    if cfg["family"] == "coati2":
        d, e = cfg["n_hidden_xformer"], cfg["embed_dim"]
        return out + _swiglu_spec("smiles_to_coati", d, e) + _swiglu_spec("coati_to_token", e, e)
    d, e = cfg["n_hidden_xformer"], cfg["n_embd_common"]
    out += _egnn_spec(cfg) + _head_spec("point_to_clip", cfg["n_hidden_e3nn"], e)
    out += _head_spec("smiles_to_clip", d, e)
    return out + [(("token_w",), (e, e), UNIFORM, e), (("token_b",), (e,), UNIFORM, e)]


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def seeded(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights drawn from `seed` on `device`: one
    uniform and one normal draw for the whole model, sliced per leaf."""
    leaves = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_uniform = sum(int(np.prod(s)) for _, s, kind, _ in leaves if kind == UNIFORM)
    n_normal = sum(int(np.prod(s)) for _, s, kind, _ in leaves if kind == NORMAL)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    normal = torch.randn(n_normal, generator=gen, device=device)
    tree: dict = {}
    at = {UNIFORM: 0, NORMAL: 0}
    for path, shape, kind, fan_in in leaves:
        size = int(np.prod(shape))
        if kind in at:
            pool = uniform if kind == UNIFORM else normal
            x = pool[at[kind]: at[kind] + size].view(shape)
            at[kind] += size
            if kind == UNIFORM:
                x = x * fan_in ** -0.5
        else:
            x = (torch.ones if kind == ONES else torch.zeros)(shape, device=device)
        _put(tree, path, x)
    return tree


def to_tensors(tree, device):
    """A nested dict of arrays (None leaves dropped) as float32 tensors."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items() if v is not None}
    return torch.as_tensor(np.asarray(tree, np.float32), device=device)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def load_document(path: str, device) -> dict:
    """The nested weights of a stacked-layer document, as tensors."""
    with open(path, "rb") as f:
        doc = pickle.load(f)
    return to_tensors(doc["model"], device)


def document(tree: dict, cfg: dict) -> dict:
    """A model document over nested weights (tensors or arrays): the
    envelope the program's loaders and its trainer's resume read."""
    if cfg["family"] == "coati2":
        kwargs = {k: cfg[k] for k in ("n_layer_xformer", "n_hidden_xformer", "embed_dim",
                                      "n_head", "n_seq", "enc_to_coati", "n_direct_clr",
                                      "n_tok", "biases")}
    else:
        kwargs = {k: cfg[k] for k in ("n_layer_xformer", "n_layer_e3gnn", "n_hidden_e3nn",
                                      "n_hidden_xformer", "n_embd_common", "biases", "n_head",
                                      "n_seq", "n_tok", "torch_emb", "norm_clips",
                                      "norm_embed", "token_mlp")}
        kwargs["use_point_encoder"] = True
    return {"train_args": {"tokenizer_vocab": cfg["vocab"]}, "dataset_summary": {},
            "model": to_numpy(tree), "model_kwargs": kwargs,
            "n_toks_processed": 0, "n_grads_processed": 0}


_BLOCK_NAMES = {
    "ln1_scale": "ln_1.weight", "ln1_bias": "ln_1.bias",
    "w_attn": "attn.c_attn.weight", "b_attn": "attn.c_attn.bias",
    "w_proj": "attn.c_proj.weight", "b_proj": "attn.c_proj.bias",
    "ln2_scale": "ln_2.weight", "ln2_bias": "ln_2.bias",
    "w_fc": "mlpf.0.weight", "b_fc": "mlpf.0.bias",
    "w_out": "mlpf.2.weight", "b_out": "mlpf.2.bias",
}
_EGNN_NAMES = {
    "edge_w1": "edge_mlp.0.weight", "edge_b1": "edge_mlp.0.bias",
    "edge_w2": "edge_mlp.3.weight", "edge_b2": "edge_mlp.3.bias",
    "node_w1": "node_mlp.0.weight", "node_b1": "node_mlp.0.bias",
    "node_w2": "node_mlp.3.weight", "node_b2": "node_mlp.3.bias",
    "coord_w1": "coord_mlp.0.weight", "coord_b1": "coord_mlp.0.bias",
    "coord_w2": "coord_mlp.2.weight",
}
_FLAT_NAMES = {
    ("xformer", "tok_emb"): "xformer.emb.tok_emb.weight",
    ("xformer", "lnf_scale"): "xformer.transformer.ln_f.weight",
    ("xformer", "lnf_bias"): "xformer.transformer.ln_f.bias",
    ("xformer", "lm_head"): "xformer.lm_head.weight",
    ("point_encoder", "embed_w"): "point_encoder.embedding.weight",
    ("point_encoder", "embed_b"): "point_encoder.embedding.bias",
    ("point_encoder", "dec_w1"): "point_encoder.node_dec.0.weight",
    ("point_encoder", "dec_b1"): "point_encoder.node_dec.0.bias",
    ("point_encoder", "dec_w2"): "point_encoder.node_dec.3.weight",
    ("point_encoder", "dec_b2"): "point_encoder.node_dec.3.bias",
    ("token_w",): "point_clip_to_special_tokens.1.weight",
    ("token_b",): "point_clip_to_special_tokens.1.bias",
}
_HEAD_NAMES = {"ln_scale": "0.weight", "ln_bias": "0.bias", "w": "1.weight", "b": "1.bias"}


def _port_names(path: tuple, layers: int):
    """The program's parameter name of a leaf, or of each layer of a
    stacked field."""
    if path[:2] == ("xformer", "blocks"):
        return [f"xformer.transformer.h.{i}.{_BLOCK_NAMES[path[2]]}" for i in range(layers)]
    if path[:2] == ("point_encoder", "layers"):
        return [f"point_encoder.gcl_{i}.{_EGNN_NAMES[path[2]]}" for i in range(layers)]
    if path[0] in ("point_to_clip", "smiles_to_clip"):
        return f"{path[0]}.{_HEAD_NAMES[path[1]]}"
    return _FLAT_NAMES[path]


def _stacked(path: tuple) -> bool:
    return path[:2] in (("xformer", "blocks"), ("point_encoder", "layers"))


def port_leaves(tree: dict) -> dict:
    """{the program's parameter name: the leaf} of COATI's nested weights,
    stacked fields split per layer (layouts differ; norms do not)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif _stacked(path):
            out.update(zip(_port_names(path, node.shape[0]), node))
        else:
            out[_port_names(path, 0)] = node

    walk(tree, ())
    return out


def from_port(named: dict, cfg: dict) -> dict:
    """COATI's nested weights from {the program's parameter name: tensor}
    (port_leaves inverted): Linear weights, (out, in) there, transposed to
    (in, out); each stacked field's layers stacked. For following a step
    from the program's own state."""
    tree: dict = {}
    for path, shape, _, _ in spec(cfg):
        names = _port_names(path, shape[0]) if _stacked(path) else [_port_names(path, 0)]
        leaves = []
        for name in names:
            x = named[name].detach().float()
            if x.dim() == 2 and path[-1] != "tok_emb":
                x = x.t()
            leaves.append(x)
        x = torch.stack(leaves) if _stacked(path) else leaves[0]
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{'.'.join(path)}: {tuple(x.shape)} is not {tuple(shape)}")
        _put(tree, path, x.contiguous())
    return tree
