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
    """Prefill over a 4-token prefix with injection, then 5 decode steps,
    by `decode_step` at the host int and by `decode_step_at` at a position
    tensor; logits and the whole cache compared after each step. The int8
    cache is compared bit for bit, its scales at the shared tolerance."""
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

    def check_cache(cache):
        if kv_dtype == "int8":
            assert cache.data.dtype == torch.int8
            np.testing.assert_array_equal(cache.data.numpy(), np.asarray(jcache.data))
            _close(cache.scale, jcache.scale)
        else:
            assert cache.scale is None
            _close(cache.data, jcache.data)

    check_cache(cache)
    # the step the decode graph captures, at a position held in a tensor,
    # over its own copy of the prefilled cache
    cache_at = ttr.KVCache(cache.data.clone(), None if cache.scale is None else cache.scale.clone())
    tables = ttr._rotary(tcfg, torch.device("cpu"))
    at = torch.tensor([p], dtype=torch.int32)
    for pos in range(p, p + 5):
        tok = toks[:, pos]
        jlogits, jcache = jtr.decode_step(jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jcache)
        logits, cache = ttr.decode_step(model, tcfg, torch.tensor(tok), pos, cache)
        _close(logits, jlogits)
        check_cache(cache)
        logits_at, cache_at = ttr.decode_step_at(model, tcfg, torch.tensor(tok), at, cache_at,
                                                 tables)
        at += 1
        _close(logits_at, jlogits)
        check_cache(cache_at)


# ------------------------------------- the decode step at a device position
#
# models/decode_graph.py captures `decode_step_at` once as a CUDA graph: the
# position lives in a one-element tensor that no host code reads. On the CPU
# every piece of it must give the bits of the step at the host int.

CACHE_FORMS = [("float32", "compute", "float32"), ("bfloat16", "compute", "float32"),
               ("float32", "int8", "float32"), ("bfloat16", "int8", "bfloat16")]


@pytest.mark.parametrize("dtype,kv_dtype,scale_dtype", CACHE_FORMS,
                         ids=["-".join(f) for f in CACHE_FORMS])
def test_kv_write_at_a_position_tensor_equals_the_int_write(dtype, kv_dtype, scale_dtype):
    tcfg = ttr.TransformerConfig(n_layer=2, n_embd=64, n_head=4, n_seq=16, dtype=dtype,
                                 kv_dtype=kv_dtype, kv_scale_dtype=scale_dtype)
    gen = torch.Generator().manual_seed(0)
    by_int = ttr.make_empty_cache(tcfg, 3, width=16)
    by_tensor = ttr.make_empty_cache(tcfg, 3, width=16)
    assert (by_int.scale is not None) == (kv_dtype == "int8")
    for layer, pos in ((0, 0), (1, 7), (1, 15), (0, 7)):
        k = torch.randn(3, 4, 16, generator=gen).to(tcfg.compute_dtype)
        v = torch.randn(3, 4, 16, generator=gen).to(tcfg.compute_dtype)
        ttr._write_kv(by_int, layer, pos, k, v)
        ttr._write_kv_at(by_tensor, layer, torch.tensor([pos]), k, v)
        assert torch.equal(by_int.data, by_tensor.data)
        if kv_dtype == "int8":
            assert torch.equal(by_int.scale, by_tensor.scale)
    assert by_int.data.abs().sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rotary_row_gathered_at_a_position_tensor(dtype):
    tcfg = ttr.TransformerConfig(n_layer=1, n_embd=64, n_head=4, n_seq=48, dtype=dtype)
    tables = ttr._rotary(tcfg, torch.device("cpu"))
    for pos in (0, 5, 47):
        cos1, sin1 = ttr.rotary_at(tables, torch.tensor([pos]))
        assert cos1.shape == (16,) and cos1.dtype == tcfg.compute_dtype
        assert torch.equal(cos1, tables[0][pos]) and torch.equal(sin1, tables[1][pos])


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_decode_step_at_a_position_tensor_equals_decode_step(kv_dtype):
    """Five steps after a prefill, by position tensor and by host int: the
    same logits and the same cache, bit for bit."""
    _, _, model, tcfg = _pair(2, 64, kv_dtype=kv_dtype, seed=3)
    b, p, width = 3, 4, 16
    toks = torch.tensor(_tokens(b, p + 5, tcfg.n_tok, seed=4))
    by_int = ttr.make_empty_cache(tcfg, b, width=width)
    by_tensor = ttr.make_empty_cache(tcfg, b, width=width)
    ttr.prefill(model, tcfg, toks[:, :p], cache=by_int)
    ttr.prefill(model, tcfg, toks[:, :p], cache=by_tensor)
    tables = ttr._rotary(tcfg, torch.device("cpu"))
    at = torch.tensor([p], dtype=torch.int32)
    for pos in range(p, p + 5):
        ref, by_int = ttr.decode_step(model, tcfg, toks[:, pos], pos, by_int)
        mine, by_tensor = ttr.decode_step_at(model, tcfg, toks[:, pos], at, by_tensor, tables)
        at += 1
        assert torch.equal(mine, ref)
        assert torch.equal(by_tensor.data, by_int.data)
        if kv_dtype == "int8":
            assert torch.equal(by_tensor.scale, by_int.scale)


def _eager_generate(model, cfg, generator, tokens, prefix_len, prefill_len, total_len, k,
                    inv_temp):
    """generate_tokens' loop spelled out with the eager decode_step, as the
    sampler ran it before decode graphs (and still runs it off the card)."""
    from coati_tpu_torch.models.sampler import sample_top_k

    tokens = tokens.clone()
    cache = ttr.make_empty_cache(cfg, tokens.shape[0], width=total_len)
    hidden, cache = ttr.prefill(model, cfg, tokens[:, :prefill_len], cache=cache)
    last = ttr.linear(hidden[:, -1], model.lm_head.weight).float()
    stopped = (tokens[:, :prefill_len] == STOP).any(1)
    pos = prefill_len
    while pos < total_len and not bool(stopped.all()):
        sampled = torch.where(stopped, 0, sample_top_k(generator, last, k, inv_temp))
        tok = torch.where(pos < prefix_len, tokens[:, pos], sampled)
        tokens[:, pos] = tok
        stopped |= tok == STOP
        logits, cache = ttr.decode_step(model, cfg, tok, pos, cache)
        last = logits.float()
        pos += 1
    tokens[:, pos - 1] = torch.where(stopped, tokens[:, pos - 1], STOP)
    return tokens


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_generate_tokens_on_the_cpu_keeps_the_eager_loops_tokens(kv_dtype, monkeypatch):
    """On CPU tensors no graph is captured, and generate_tokens gives the
    eager loop's tokens for one generator seed, sampled (k 5) and with
    rows behind prefixes of different lengths."""
    from coati_tpu_torch.models.sampler import generate_tokens
    from coati_tpu_torch.ops import graphs

    def no_capture(*args, **kwargs):
        raise AssertionError("a decode graph was captured on the CPU")

    monkeypatch.setattr(graphs, "capture", no_capture)
    _, _, model, tcfg = _pair(2, 64, kv_dtype=kv_dtype, seed=5)
    b, total = 4, 24
    tokens = torch.zeros(b, total, dtype=torch.long)
    tokens[:, :5] = torch.tensor(_tokens(b, 5, tcfg.n_tok, seed=6)) % 30 + 3
    lens = torch.tensor([3, 5, 3, 4])
    for k in (1, 5):
        mine = generate_tokens(model, tcfg, torch.Generator().manual_seed(11), tokens, lens,
                               prefill_len=3, total_len=total, stop_token=STOP, k=k,
                               inv_temp=1.0)
        ref = _eager_generate(model, tcfg, torch.Generator().manual_seed(11), tokens, lens, 3,
                              total, k, 1.0)
        assert torch.equal(mine, ref)
        assert torch.equal(mine[1, :5], tokens[1, :5])


def test_the_decode_graph_engages_only_for_cuda_weights_in_the_compute_dtype():
    """The rule of decode_graph.eligible: a CUDA device, weights that
    cast_floats hands back as they are (so the same tensors from call to
    call), and no `graphs.eager()` block open (in any thread); CPU tensors,
    weights cast anew on each call, or a call inside such a block take the
    eager step."""
    import threading

    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs
    from coati_tpu_torch.ops.layers import cast_floats

    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    _, _, model, tcfg = _pair(2, 64)
    assert cast_floats(model, torch.float32) is model
    assert decode_graph.eligible(model, model, cuda)
    assert not decode_graph.eligible(model, model, cpu)
    recast = cast_floats(model, torch.bfloat16)  # float32 masters under bf16 compute
    assert recast is not model and cast_floats(model, torch.bfloat16) is not recast
    assert not decode_graph.eligible(model, recast, cuda)
    assert cast_floats(recast, torch.bfloat16) is recast  # a handle's compute copy
    assert decode_graph.eligible(recast, recast, cuda)
    seen = []
    with graphs.eager():
        with graphs.eager():
            assert not decode_graph.eligible(recast, recast, cuda)
        other = threading.Thread(target=lambda: seen.append(
            decode_graph.eligible(recast, recast, cuda)))
        other.start()
        other.join(timeout=30)
        assert not decode_graph.eligible(recast, recast, cuda)
    assert seen == [False] and decode_graph.eligible(recast, recast, cuda)


def _stand_in_captures(monkeypatch):
    """decode_graph with the card-bound pieces of ops/graphs.py stood in
    for (tests/graph_stand_ins.py), and no shape met yet; returns the
    stand-ins, whose `made` lists the graphs captured."""
    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs
    from tests import graph_stand_ins

    monkeypatch.setattr(decode_graph, "_seen", graphs.LRU(decode_graph.SEEN_SHAPES))
    return graph_stand_ins.install(monkeypatch)


def _acquire_once(model, tcfg, batch):
    """A call's graph of the shape (None where it runs eagerly), given back."""
    from coati_tpu_torch.models import decode_graph

    graph = decode_graph._acquire(model, tcfg, batch, 16, "cpu")
    if graph is not None:
        graph.lock.release()
    return graph


def test_kept_decode_graphs_are_bounded_reused_and_freed_with_the_weights(monkeypatch):
    """decode_graph keeps at most MAX_SHAPES graphs a weights module, the
    least recently used going first; hands a held graph to no second call;
    captures again when a weight tensor is replaced; and drops them all
    with the module."""
    import gc
    import weakref

    from torch import nn

    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs

    stand_ins = _stand_in_captures(monkeypatch)
    made = stand_ins.made
    _, _, model, tcfg = _pair(2, 64)
    n = decode_graph.MAX_SHAPES

    def acquire(batch):
        return _acquire_once(model, tcfg, batch)

    assert [acquire(b) for b in range(1, n + 2)] == [None] * (n + 1)  # met once: eager
    first = [acquire(b) for b in range(1, n + 1)]
    assert acquire(1) is first[0] and len(made) == n  # kept, and now the most recent
    acquire(n + 1)  # evicts batch 2, the least recently used
    assert decode_graph.kept_shapes(model) == n
    assert [g.token.shape[0] for g in decode_graph.kept_graphs(model)] == [
        *range(3, n + 1), 1, n + 1]
    assert acquire(1) is first[0] and acquire(2) is not first[1]
    held = decode_graph._acquire(model, tcfg, 1, 16, "cpu")
    assert held is first[0] and decode_graph._acquire(model, tcfg, 1, 16, "cpu") is None
    held.lock.release()
    model.lm_head.weight = nn.Parameter(model.lm_head.weight.clone(), requires_grad=False)
    again = acquire(1)
    assert again is not first[0] and again.layout == graphs.layout(decode_graph._weights(model))
    before = len(decode_graph._kept)
    ref = weakref.ref(model)
    stand_ins.release()
    del model, first, held, again
    gc.collect()
    assert ref() is None and len(decode_graph._kept) == before - 1


def test_a_decode_graph_is_captured_on_the_second_use_of_its_shape(monkeypatch):
    """A key is captured on its second use by any module: the first call of
    a shape runs eagerly, a second module's first call of a shape met before
    captures; the last SEEN_SHAPES keys are remembered."""
    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops import graphs

    made = _stand_in_captures(monkeypatch).made
    monkeypatch.setattr(decode_graph, "_seen", graphs.LRU(3))
    _, _, model, tcfg = _pair(2, 64)
    _, _, other, _ = _pair(2, 64, seed=1)
    assert _acquire_once(model, tcfg, 8) is None and made == []
    assert _acquire_once(model, tcfg, 8).graph is made[0]
    assert _acquire_once(other, tcfg, 8).graph is made[1]  # the shape, not the module, was met
    for b in (1, 2, 3):
        assert _acquire_once(model, tcfg, b) is None
    assert _acquire_once(other, tcfg, 1).graph is made[2]  # still remembered
    assert _acquire_once(other, tcfg, 9) is None
    assert _acquire_once(other, tcfg, 2) is None  # forgotten: 2 was the oldest of 3
    assert len(made) == 3


def test_a_decode_graph_follows_its_weights_storage_not_their_objects(monkeypatch):
    """A graph reads weights by address: `param.data = ...` keeps the
    Parameter object but moves its storage, so the next call captures
    anew; a weight changed in place stays where the graph reads it and
    keeps the graph."""
    made = _stand_in_captures(monkeypatch).made
    _, _, model, tcfg = _pair(2, 64)
    _acquire_once(model, tcfg, 4)
    graph = _acquire_once(model, tcfg, 4)
    assert graph.graph is made[0]
    with torch.no_grad():
        model.lm_head.weight.mul_(2.0)
    assert _acquire_once(model, tcfg, 4) is graph
    weight = kept = model.transformer.h[0].attn.c_attn.weight
    weight.data = weight.data.clone()
    assert weight is kept
    again = _acquire_once(model, tcfg, 4)
    assert again is not graph and len(made) == 2
    assert _acquire_once(model, tcfg, 4) is again


def test_k1_counts_a_captured_launch_at_each_replay(monkeypatch):
    """K1's wrappers count a launch made while the stream is captured in
    the capture's recording, not in `.launches`; a StepGraph's replay adds
    exactly what its capture recorded; outside a recording a captured
    launch is counted nowhere."""
    from coati_tpu_torch.models import decode_graph
    from coati_tpu_torch.ops.kernels import build
    from coati_tpu_torch.ops.kernels import decode_attention as k1

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    monkeypatch.setattr(build, "_stream_key", lambda: 7)  # one stream, on the CPU
    monkeypatch.setattr(k1.decode_attention, "launches", 0)
    monkeypatch.setattr(k1.decode_attention_quant, "launches", 0)
    build.count_launch(k1.decode_attention_quant)
    assert k1.decode_attention_quant.launches == 1
    capturing[0] = True
    build.count_launch(k1.decode_attention_quant)  # no recording: counted nowhere
    with build.recording_launches() as recorded:
        for _ in range(3):
            build.count_launch(k1.decode_attention_quant)
        build.count_launch(k1.decode_attention)
    assert recorded == {(k1.decode_attention_quant, "launches"): 3,
                        (k1.decode_attention, "launches"): 1}
    assert (k1.decode_attention_quant.launches, k1.decode_attention.launches) == (1, 0)
    capturing[0] = False

    class Replayed:
        replays = 0

        def replay(self):
            Replayed.replays += 1

    step = object.__new__(decode_graph.StepGraph)
    step.token, step.logits, step.graph = torch.zeros(2, dtype=torch.long), "logits", Replayed()
    step.launches = recorded
    for _ in range(5):
        assert step.step(torch.ones(2, dtype=torch.long)) == "logits"
    assert Replayed.replays == 5 and torch.equal(step.token, torch.ones(2, dtype=torch.long))
    assert (k1.decode_attention_quant.launches, k1.decode_attention.launches) == (16, 5)


def test_decode_graphs_are_held_by_one_call_at_a_time_under_threads(monkeypatch):
    """Many threads take and give back graphs of a few shapes (a stand-in
    for the capture): no graph is ever held by two at once, none is lost
    while held, and at most MAX_SHAPES stay kept once all are given back."""
    import sys
    import threading

    from coati_tpu_torch.models import decode_graph

    _stand_in_captures(monkeypatch)
    _, _, model, tcfg = _pair(2, 64)
    clashes, taken = [], []

    def work(i):
        for j in range(150):
            graph = decode_graph._acquire(model, tcfg, 1 + (i + j) % 6, 16, "cpu")
            if graph is None:
                continue  # held by another call: that call decodes eagerly
            if getattr(graph, "holder", None) is not None:
                clashes.append((i, j))
            graph.holder = i
            taken.append(1)
            if graph.holder != i:
                clashes.append((i, j))
            graph.holder = None
            graph.lock.release()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    assert clashes == [] and len(taken) > 0
    assert decode_graph.kept_shapes(model) <= decode_graph.MAX_SHAPES
