"""coati_tpu_torch transformer against coati_tpu on the CPU, at 2-3
layers, widths 64 and 128, 4 heads: the full forward and encode, the
training forward to logits with the gradient of every parameter (both
attention routes, with and without rematerialization, and bf16 over float32
masters), and prefill followed by decode steps, logits and KV cache (float32
and int8).

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
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


def _transformer_grads(jgrads):
    state = transformer_state_from_coati_tpu(params_to_state(jgrads))
    return {k: v.numpy() for k, v in state.items()}


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("route", ["packed", "auto"], ids=["packed_K5", "flash_K2"])
def test_forward_logits_values_and_gradients_match_jax(route, remat):
    """forward_logits and forward_with_stop_emb with an injected clip token,
    and the gradients of a scalar loss with respect to every parameter and
    to the injection, through either attention Function, with and without
    per-block rematerialization (torch.utils.checkpoint against
    jax.checkpoint)."""
    jparams, jcfg, model, tcfg = _pair(2, 64, seed=9, remat=remat)
    model.requires_grad_(True)
    tcfg = tcfg.replace(prefill_kernel=route)
    toks = _tokens(3, 20, tcfg.n_tok, seed=10)
    rng = np.random.default_rng(11)
    inj = rng.normal(size=(3, 64)).astype(np.float32)
    g = rng.normal(size=(3, 20, tcfg.n_tok)).astype(np.float32)
    gs = rng.normal(size=(3, 64)).astype(np.float32)

    def jloss(params, injection):
        logits, stop = jtr.forward_with_stop_emb(params, jcfg, jnp.asarray(toks), STOP,
                                                 injection, UNK)
        return jnp.sum(logits * g) + jnp.sum(stop * gs), (logits, stop)

    (_, (jlogits, jstop)), (jgrads, jdinj) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(inj))
    tinj = torch.tensor(inj, requires_grad=True)
    logits, stop = ttr.forward_with_stop_emb(model, tcfg, torch.tensor(toks), STOP, tinj, UNK)
    _close(logits.detach(), jlogits)
    _close(stop.detach(), jstop)
    _close(ttr.forward_logits(model, tcfg, torch.tensor(toks), tinj, UNK).detach(), jlogits)
    ((logits * torch.tensor(g)).sum() + (stop * torch.tensor(gs)).sum()).backward()
    ref = _transformer_grads(jgrads)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(ref)
    for name, p in model.named_parameters():
        # sums over 60 tokens and 40 logits each
        np.testing.assert_allclose(p.grad.numpy(), ref[name], atol=1e-4, rtol=1e-4, err_msg=name)
    _close(tinj.grad, jdinj, atol=1e-4)


def test_encode_bf16_leaves_float32_gradients_on_the_masters():
    """Under bf16 compute a loss through encode reaches the float32 master
    parameters: each gets a non-zero float32 .grad that points the way of
    the float32 gradient (bf16 activations through two blocks), apart from
    lm_head, which encode does not use."""
    _, _, model, tcfg = _pair(2, 64, seed=12)
    model.requires_grad_(True)
    toks = torch.tensor(_tokens(3, 20, tcfg.n_tok, seed=13))
    g = torch.tensor(np.random.default_rng(14).normal(size=(3, 64)).astype(np.float32))
    (ttr.encode(model, tcfg, toks, STOP) * g).sum().backward()
    full = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    half = ttr.encode(model, tcfg.replace(dtype="bfloat16"), toks, STOP)
    assert half.dtype == torch.bfloat16
    (half.float() * g).sum().backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if name == "lm_head.weight":
            assert p.grad is None
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32 and p.grad.any(), name
        cos = torch.nn.functional.cosine_similarity(p.grad.flatten(), full[name].flatten(), dim=0)
        assert cos > 0.98, (name, float(cos))


def test_packed_prefill_kernel_raises_and_bad_fields_are_rejected():
    """prefill_kernel="packed" is the short-sequence kernel: it refuses
    T > 128 and a single head with coati_tpu's message, in the full forward
    and in the prefill; unknown field values are rejected."""
    _, _, model, tcfg = _pair(2, 64, n_seq=160)
    packed = tcfg.replace(prefill_kernel="packed")
    long = torch.tensor(_tokens(2, 129, tcfg.n_tok))
    with pytest.raises(ValueError, match="needs T <= 128 and n_head > 1, got T=129"):
        ttr.forward_hidden(model, packed, long)
    with pytest.raises(ValueError, match="needs T <= 128 and n_head > 1, got T=129"):
        ttr.prefill(model, packed, long)
    toks = torch.tensor(_tokens(2, 8, tcfg.n_tok))
    with pytest.raises(ValueError, match="n_head=1"):
        ttr.forward_hidden(model, packed.replace(n_head=1), toks)
    with pytest.raises(ValueError):
        ttr.forward_hidden(model, tcfg.replace(prefill_kernel="fast"), toks)
    with pytest.raises(ValueError):
        ttr.make_empty_cache(tcfg.replace(kv_dtype="int4"), 2)
    # every other TPU-era choice routes to the port's flash kernel path
    ref = ttr.forward_hidden(model, tcfg, toks)
    for choice in ("xla", "pallas"):
        _close(ttr.forward_hidden(model, tcfg.replace(prefill_kernel=choice), toks), ref.numpy(), 0, 0)


@pytest.mark.parametrize("t", [3, 37, 128])
def test_packed_prefill_kernel_matches_auto_and_jax_packed(t, monkeypatch):
    """Under prefill_kernel="packed" the forward, the encode and the prefill
    go through the K5f wrapper (and not K2's) and, on the CPU, equal the
    "auto" setting; the forward also matches coati_tpu under its packed
    Pallas kernel, which runs in interpret mode on the CPU (128 wide, which
    that kernel needs)."""
    jparams, jcfg, model, tcfg = _pair(2, 128, n_seq=128, seed=6)
    toks = _tokens(2, t, tcfg.n_tok, seed=7)
    inj = np.random.default_rng(8).normal(size=(2, 128)).astype(np.float32)
    packed = tcfg.replace(prefill_kernel="packed")
    auto = ttr.forward_hidden(model, tcfg, torch.tensor(toks), torch.tensor(inj), UNK)
    auto_h, auto_cache = ttr.prefill(model, tcfg, torch.tensor(toks), torch.tensor(inj), UNK)

    calls = []
    wrapper = ttr.packed_causal_attention
    monkeypatch.setattr(ttr, "packed_causal_attention", lambda *a: calls.append(1) or wrapper(*a))
    monkeypatch.setattr(ttr, "flash_causal_attention", None)  # must not be reached
    mine = ttr.forward_hidden(model, packed, torch.tensor(toks), torch.tensor(inj), UNK)
    h, cache = ttr.prefill(model, packed, torch.tensor(toks), torch.tensor(inj), UNK)
    enc = ttr.encode(model, packed, torch.tensor(toks), STOP)
    assert len(calls) == 3 * tcfg.n_layer
    _close(mine, auto.numpy(), 0, 0)
    _close(h, auto_h.numpy(), 0, 0)
    _close(cache.data, auto_cache.data.numpy(), 0, 0)
    ref = jtr.forward_hidden(
        jparams, jcfg.replace(prefill_kernel="packed"), jnp.asarray(toks), jnp.asarray(inj), UNK
    )
    _close(mine, ref)
    _close(enc, jtr.encode(jparams, jcfg, jnp.asarray(toks), STOP))


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
