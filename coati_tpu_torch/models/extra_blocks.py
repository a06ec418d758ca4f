"""Non-rotary transformer blocks and learned positional embedding.

PyTorch counterpart of coati_tpu/models/extra_blocks.py, which completes
the reference basic_transformer surface
(coati/models/encoding/basic_transformer.py:177-321: CausalSelfAttention/
Block, NonCausalSelfAttention/NonCausalBlock; smiles_xformer.py:25-47:
SimpleTokenEmbedding). The flagship models use the rotary blocks of
models/transformer.py; these variants exist for API parity and ablations.
Their attention is plain PyTorch, as it is plain XLA in the JAX package:
no main path runs it, and it has no kernel. A Block / NonCausalBlock's
weights are models/transformer.py's `Block`, under the reference's keys
('ln_1', 'attn.c_attn', 'attn.c_proj', 'ln_2', 'mlpf.0', 'mlpf.2').
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
from torch import nn

from coati_tpu_torch.models.transformer import Block
from coati_tpu_torch.ops.layers import gelu_tanh, layer_norm, linear


class SimpleTokenEmbedding(nn.Module):
    """Joint learned token + positional embedding (smiles_xformer.py:25-47);
    both tables take nn.Embedding's N(0, 1) initialisation."""

    def __init__(self, n_tok: int, n_seq: int, n_embd: int):
        super().__init__()
        self.tok_emb = nn.Embedding(n_tok, n_embd)
        self.pos_emb = nn.Embedding(n_seq, n_embd)


def simple_token_embedding(p: SimpleTokenEmbedding, tokens: torch.Tensor) -> torch.Tensor:
    t = tokens.shape[1]
    return p.tok_emb.weight[tokens] + p.pos_emb.weight[:t][None, :, :]


def _self_attention(x: torch.Tensor, p: Block, n_head: int, causal: bool) -> torch.Tensor:
    b, t, d = x.shape
    dh = d // n_head
    qkv = linear(x, p.attn.c_attn.weight, p.attn.c_attn.bias)
    q, k, v = (y.reshape(b, t, n_head, dh) for y in qkv.split(d, dim=-1))
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() / math.sqrt(dh)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    y = torch.einsum("bhts,bshd->bthd", probs, v).reshape(b, t, d)
    return linear(y, p.attn.c_proj.weight, p.attn.c_proj.bias)


def plain_block(x: torch.Tensor, p: Block, n_head: int, causal: bool = True) -> torch.Tensor:
    """Block / NonCausalBlock forward (basic_transformer.py:231-321)."""
    x = x + _self_attention(layer_norm(x, p.ln_1.weight, p.ln_1.bias), p, n_head, causal)
    y = layer_norm(x, p.ln_2.weight, p.ln_2.bias)
    fc, out = p.mlpf[0], p.mlpf[2]
    return x + linear(gelu_tanh(linear(y, fc.weight, fc.bias)), out.weight, out.bias)


def convert_plain_block(sd: Mapping[str, object], prefix: str = "") -> Block:
    """A reference Block / NonCausalBlock state dict (keys under `prefix`)
    loaded strictly into the port's Block."""
    from coati_tpu_torch.models.convert import _tensor

    own = {k[len(prefix):]: _tensor(v) for k, v in sd.items() if k.startswith(prefix)}
    block = Block(own["ln_1.weight"].shape[0], "attn.c_attn.bias" in own)
    block.load_state_dict(own, strict=True)
    return block
