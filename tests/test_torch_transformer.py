"""coati_tpu_torch transformer against coati_tpu on the CPU, at 2-3
layers, widths 64 and 128, 4 heads: the full forward and encode, and
prefill followed by decode steps, logits and KV cache (float32 and int8).

Same weights (JAX init, carried across by convert.py) and the same numpy
tokens in both. Tolerance atol 3e-5, rtol 1e-4 (float32 summation order)
unless a line says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.models import transformer as jtr
from coati_tpu.models.io import params_to_state

from coati_tpu_torch.models import transformer as ttr
from coati_tpu_torch.models.convert import transformer_state_from_coati_tpu

ATOL, RTOL = 3e-5, 1e-4
STOP, UNK = 2, 1


def _pair(n_layer, n_embd, n_seq=48, n_tok=40, norm_embed=False, seed=0, **kw):
    jcfg = jtr.TransformerConfig(
        n_layer=n_layer, n_embd=n_embd, n_head=4, n_seq=n_seq, n_tok=n_tok,
        norm_embed=norm_embed, precision="highest", prefill_kernel="xla", **kw,
    )
    jparams = jtr.init_transformer(jax.random.PRNGKey(seed), jcfg)
    tcfg = ttr.TransformerConfig(
        n_layer=n_layer, n_embd=n_embd, n_head=4, n_seq=n_seq, n_tok=n_tok,
        norm_embed=norm_embed, **kw,
    )
    model = ttr.SmilesTransformer(tcfg)
    model.load_state_dict(transformer_state_from_coati_tpu(params_to_state(jparams)), strict=True)
    model.requires_grad_(False)
    return jparams, jcfg, model, tcfg


def _tokens(b, t, n_tok, seed=1):
    toks = np.random.default_rng(seed).integers(3, n_tok, size=(b, t))
    toks[:, t // 2] = UNK
    toks[:, -2] = STOP
    toks[:, -1] = 0
    return toks


def _close(mine, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize(
    "n_layer,n_embd,norm_embed", [(2, 64, False), (3, 128, False), (2, 64, True)]
)
def test_forward_hidden_and_encode_match_jax(n_layer, n_embd, norm_embed):
    jparams, jcfg, model, tcfg = _pair(n_layer, n_embd, norm_embed=norm_embed)
    toks = _tokens(3, 20, tcfg.n_tok)
    inj = np.random.default_rng(2).normal(size=(3, n_embd)).astype(np.float32)
    ref = jtr.forward_hidden(jparams, jcfg, jnp.asarray(toks), jnp.asarray(inj), UNK)
    mine = ttr.forward_hidden(model, tcfg, torch.tensor(toks), torch.tensor(inj), UNK)
    _close(mine, ref)
    _close(
        ttr.encode(model, tcfg, torch.tensor(toks), STOP),
        jtr.encode(jparams, jcfg, jnp.asarray(toks), STOP),
    )


def test_packed_prefill_kernel_raises_and_bad_fields_are_rejected():
    _, _, model, tcfg = _pair(2, 64)
    toks = torch.tensor(_tokens(2, 8, tcfg.n_tok))
    with pytest.raises(NotImplementedError, match="K5"):
        ttr.forward_hidden(model, tcfg.replace(prefill_kernel="packed"), toks)
    with pytest.raises(ValueError):
        ttr.forward_hidden(model, tcfg.replace(prefill_kernel="fast"), toks)
    with pytest.raises(ValueError):
        ttr.make_empty_cache(tcfg.replace(kv_dtype="int4"), 2)
    # every TPU-era choice routes to the port's own kernel path
    ref = ttr.forward_hidden(model, tcfg, toks)
    for choice in ("xla", "pallas"):
        _close(ttr.forward_hidden(model, tcfg.replace(prefill_kernel=choice), toks), ref.numpy(), 0, 0)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
@pytest.mark.parametrize("n_layer,n_embd", [(2, 64), (3, 128)])
def test_prefill_and_decode_steps_match_jax(n_layer, n_embd, kv_dtype):
    """Prefill over a 4-token prefix with injection, then 5 decode steps;
    logits and the whole cache compared after each step. The int8 cache is
    compared bit for bit, its scales at the shared tolerance."""
    jparams, jcfg, model, tcfg = _pair(n_layer, n_embd, kv_dtype=kv_dtype, seed=3)
    b, p, width = 3, 4, 16
    toks = _tokens(b, p + 5, tcfg.n_tok, seed=4)
    toks[:, 1] = UNK
    inj = np.random.default_rng(5).normal(size=(b, n_embd)).astype(np.float32)

    jcache = jtr.make_empty_cache(jcfg, b, width=width)
    jh, jcache = jtr.prefill(jparams, jcfg, jnp.asarray(toks[:, :p]), jnp.asarray(inj), UNK, jcache)
    cache = ttr.make_empty_cache(tcfg, b, width=width)
    h, cache = ttr.prefill(model, tcfg, torch.tensor(toks[:, :p]), torch.tensor(inj), UNK, cache)
    _close(h, jh)

    def check_cache():
        if kv_dtype == "int8":
            assert cache.data.dtype == torch.int8
            np.testing.assert_array_equal(cache.data.numpy(), np.asarray(jcache.data))
            _close(cache.scale, jcache.scale)
        else:
            assert cache.scale is None
            _close(cache.data, jcache.data)

    check_cache()
    for pos in range(p, p + 5):
        tok = toks[:, pos]
        jlogits, jcache = jtr.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache)
        logits, cache = ttr.decode_step(model, tcfg, torch.tensor(tok), pos, cache)
        _close(logits, jlogits)
        check_cache()
