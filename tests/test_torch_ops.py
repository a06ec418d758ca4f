"""coati_tpu_torch ops against coati_tpu on the CPU: layers, rotary, the
plain attention functions, the two kernels' CPU paths (against the Pallas
kernels in interpret mode), int8 KV quantization and top-k sampling.

Inputs come from numpy seeds and go to both packages. Shared tolerance,
as in the repo's parity tests: atol 3e-5, rtol 1e-4 (float32 summation
order); lines that differ say why."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.models.transformer import quantize_kv as jax_quantize_kv
from coati_tpu.ops import attention as jatt
from coati_tpu.ops import layers as jlayers
from coati_tpu.ops import rotary as jrot
from coati_tpu.ops import sampling as jsamp
from coati_tpu.ops.pallas.decode_attention import (
    decode_attention_pallas,
    decode_attention_pallas_quant,
)
from coati_tpu.ops.pallas.flash_attention import flash_causal_attention as jax_flash

from coati_tpu_torch.models.transformer import quantize_kv
from coati_tpu_torch.ops import attention as tatt
from coati_tpu_torch.ops import layers as tlayers
from coati_tpu_torch.ops import rotary as trot
from coati_tpu_torch.ops import sampling as tsamp
from coati_tpu_torch.ops.kernels import decode_attention as kdecode
from coati_tpu_torch.ops.kernels import flash_attention as kflash

ATOL, RTOL = 3e-5, 1e-4
HIGHEST = jax.lax.Precision.HIGHEST


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(mine, ref, atol=ATOL, rtol=RTOL):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    np.testing.assert_allclose(mine, np.asarray(ref, np.float32), atol=atol, rtol=rtol)


# ------------------------------------------------------------------ layers


def test_layer_norm_and_gelu_match_jax():
    x, s, b = _normal(0, 4, 7, 64), _normal(1, 64), _normal(2, 64)
    _close(tlayers.layer_norm(_t(x), _t(s), _t(b)), jlayers.layer_norm(x, s, b))
    _close(tlayers.gelu_tanh(_t(x)), jlayers.gelu_tanh(x))


def test_linear_and_cast_floats():
    x, w, b = _normal(3, 5, 32), _normal(4, 32, 48), _normal(5, 48)
    # the port stores (out, in): the transpose of the JAX layout
    _close(tlayers.linear(_t(x), _t(w.T), _t(b)), jlayers.linear(x, w, b, HIGHEST))
    lin = torch.nn.Linear(4, 4)
    assert tlayers.cast_floats(lin, torch.float32) is lin
    cast = tlayers.cast_floats(lin, torch.bfloat16)
    assert cast is not lin and cast.weight.dtype == torch.bfloat16
    assert lin.weight.dtype == torch.float32  # the master copy is untouched
    assert tlayers.cast_floats(cast, torch.bfloat16) is cast


@pytest.mark.parametrize("head_dim", [16, 32])
def test_rotary_matches_jax(head_dim):
    cos, sin = trot.rotary_tables(250, head_dim)
    jcos, jsin = jrot.rotary_tables(250, head_dim)
    # cos/sin of arguments up to 249 rad: float32 range reduction differs by ulps
    _close(cos, jcos, atol=1e-5)
    _close(sin, jsin, atol=1e-5)
    x = _normal(6, 2, 9, 4, head_dim)
    c, s = np.asarray(jcos)[:9, None, :], np.asarray(jsin)[:9, None, :]
    _close(trot.apply_rotary(_t(x), _t(c), _t(s)), jrot.apply_rotary(x, c, s))


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("t", [1, 9, 40])
def test_causal_attention_f32_softmax_matches_jax(t):
    q, k, v = (_normal(i, 2, t, 4, 16) for i in (10, 11, 12))
    ref = jatt.causal_attention(q, k, v, HIGHEST, jnp.float32)
    _close(tatt.causal_attention(_t(q), _t(k), _t(v), torch.float32), ref)


def test_causal_attention_bf16_softmax_matches_jax():
    """softmax_dtype=bf16 keeps the probs in bf16, with the -1e4 mask. The
    two frameworks round bf16 intermediates at different points, so the
    tolerance is bf16's: 2**-7 relative, on outputs of order 1."""
    q, k, v = (_normal(i, 2, 24, 4, 16) for i in (13, 14, 15))
    ref = jatt.causal_attention(q, k, v, HIGHEST, jnp.bfloat16)
    mine = tatt.causal_attention(_t(q), _t(k), _t(v), torch.bfloat16)
    _close(mine, ref, atol=2e-2, rtol=2e-2)
    # the -1e4 mask still zeroes the future: row 0 attends to key 0 only
    _close(mine[:, 0], v[:, 0], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("t", [16, 40, 96])
def test_flash_cpu_path_matches_pallas_kernel(t):
    """The port's K2 wrapper (plain path on a CPU tensor) against the TPU
    kernel run in interpret mode, at H*Dh = 128 (which the TPU kernel needs)."""
    q, k, v = (_normal(i, 2, t, 8, 16) for i in (20, 21, 22))
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True)
    before = kflash.flash_causal_attention.launches
    _close(kflash.flash_causal_attention(_t(q), _t(k), _t(v)), ref)
    assert kflash.flash_causal_attention.launches == before


def test_flash_cpu_path_takes_strided_views():
    """q/k/v split out of the fused qkv projection are strided views; the
    wrapper takes them as they are."""
    b, t, h, dh = 2, 12, 4, 16
    qkv = _t(_normal(23, b, t, 3 * h * dh))
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    assert not v.is_contiguous()
    ref = jatt.causal_attention(*(x.contiguous().numpy() for x in (q, k, v)), HIGHEST)
    _close(kflash.flash_causal_attention(q, k, v), ref)


T_CACHE = 64  # a multiple of 8, so the Pallas kernel really runs


@pytest.mark.parametrize("pos", [0, 5, 37, T_CACHE - 1])
def test_decode_attention_matches_jax_and_pallas(pos):
    b, h, dh = 3, 4, 16
    q = _normal(30, b, h, dh)
    k, v = _normal(31, b, T_CACHE, h, dh), _normal(32, b, T_CACHE, h, dh)
    mine = kdecode.decode_attention(_t(q), _t(k), _t(v), pos)
    _close(tatt.decode_attention(_t(q), _t(k), _t(v), pos), mine, atol=0, rtol=0)
    _close(mine, jatt.decode_attention(q, k, v, jnp.asarray(pos), HIGHEST))
    _close(mine, decode_attention_pallas(q, k, v, jnp.asarray(pos), interpret=True))


@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 21, T_CACHE - 1])
def test_decode_attention_quant_matches_jax_and_pallas(pos, scale_dtype):
    b, h, dh = 2, 4, 32
    q = _normal(33, b, h, dh)
    k8, ks = quantize_kv(_t(_normal(34, b, T_CACHE, h, dh)))
    v8, vs = quantize_kv(_t(_normal(35, b, T_CACHE, h, dh)))
    ks, vs = ks.to(scale_dtype), vs.to(scale_dtype)
    mine = kdecode.decode_attention_quant(_t(q), k8, ks, v8, vs, pos)
    jargs = [jnp.asarray(x.float().numpy()) for x in (k8, ks, v8, vs)]
    jargs[0], jargs[2] = jargs[0].astype(jnp.int8), jargs[2].astype(jnp.int8)
    if scale_dtype == torch.bfloat16:
        jargs[1], jargs[3] = jargs[1].astype(jnp.bfloat16), jargs[3].astype(jnp.bfloat16)
    k8j, ksj, v8j, vsj = jargs
    _close(mine, jatt.decode_attention_quant(q, k8j, ksj, v8j, vsj, jnp.asarray(pos)))
    _close(
        mine,
        decode_attention_pallas_quant(q, k8j, ksj, v8j, vsj, jnp.asarray(pos), interpret=True),
    )


def test_decode_wrappers_keep_cpu_counters_at_zero():
    q, k = _t(_normal(36, 2, 2, 16)), _t(_normal(37, 2, 8, 2, 16))
    before = (kdecode.decode_attention.launches, kdecode.decode_attention_quant.launches)
    kdecode.decode_attention(q, k, k, 3)
    k8, ks = quantize_kv(k)
    kdecode.decode_attention_quant(q, k8, ks, k8, ks, 3)
    assert (kdecode.decode_attention.launches, kdecode.decode_attention_quant.launches) == before


# -------------------------------------------------------------- quantization


def test_quantize_kv_bit_exact_including_ties():
    x = _normal(40, 3, 17, 4, 16) * 3.0
    # one head with amax 127 (scale exactly 1.0) and half-way values:
    # round half to even gives 2, -4, 0, 6
    x[0, 0, 0, :5] = [127.0, 2.5, -3.5, 0.5, 5.5]
    x[0, 0, 0, 5:] = 0.0
    q8, scale = quantize_kv(_t(x))
    jq8, jscale = jax_quantize_kv(jnp.asarray(x))
    assert q8.dtype == torch.int8
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert q8[0, 0, 0, :5].tolist() == [127, 2, -4, 0, 6]


# ----------------------------------------------------------------- sampling


def test_sample_top_k_greedy_is_token_exact():
    logits = _normal(50, 64, 300)
    logits[:4, 7] = logits[:4, 11] = 50.0  # tied maxima: the lower index wins
    ref = jsamp.sample_top_k(jax.random.PRNGKey(0), jnp.asarray(logits), 1, 2.0, approx=False)
    mine = tsamp.sample_top_k(torch.Generator().manual_seed(0), _t(logits), 1, 2.0)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    assert mine[:4].tolist() == [7] * 4


def test_top_k_candidates_match_lax_top_k_with_ties():
    """Exactly k candidates, in lax.top_k's order: descending, ties by
    lower index, including a tie straddling the k-th place."""
    logits = np.random.default_rng(51).integers(0, 6, size=(32, 40)).astype(np.float32)
    vals, idxs = tsamp.top_k_candidates(_t(logits), 9)
    jvals, jidxs = jax.lax.top_k(jnp.asarray(logits), 9)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idxs.numpy(), np.asarray(jidxs))


def _counts(draws, n_tok):
    return np.bincount(draws.numpy(), minlength=n_tok)


def _assert_4sigma(counts, probs):
    n = counts.sum()
    for i, p in enumerate(probs):
        sigma = np.sqrt(n * p * (1 - p))
        assert abs(counts[i] - n * p) < 4 * sigma + 1, (i, counts[i], n * p)


def test_sample_top_k_distribution_4sigma():
    """k > 1: draws against the exact top-k softmax, binomial 4-sigma bound
    per token (the random streams of the two frameworks differ)."""
    base = _normal(52, 12)
    k, inv_temp, n = 5, 1.5, 20000
    masked = np.asarray(jsamp.top_k_filter(jnp.asarray(base), k)) * inv_temp
    probs = np.exp(masked - masked.max())
    probs /= probs.sum()
    logits = np.tile(base, (n, 1))
    draws = tsamp.sample_top_k(torch.Generator().manual_seed(1), _t(logits), k, inv_temp)
    counts = _counts(draws, 12)
    assert counts[probs == 0].sum() == 0
    _assert_4sigma(counts, probs)


def test_sample_top_k_boundary_tie_keeps_lower_index():
    row = np.asarray([5.0, 3.0, 3.0, 3.0, 1.0], np.float32)
    draws = tsamp.sample_top_k(torch.Generator().manual_seed(2), _t(np.tile(row, (4000, 1))), 2, 1.0)
    counts = _counts(draws, 5)
    assert set(np.nonzero(counts)[0]) == {0, 1}
    p1 = 1.0 / (1.0 + np.exp(2.0))
    _assert_4sigma(counts[:2], [1 - p1, p1])


def test_sample_top_p_matches_jax_nucleus():
    base = _normal(53, 10) * 2.0
    k, inv_temp, top_p, n = 10, 1.0, 0.7, 20000
    kept = np.asarray(jsamp.top_p_filter(jnp.asarray(base * inv_temp), top_p, k))
    probs = np.where(np.isfinite(kept), np.exp(kept - kept.max()), 0.0)
    probs /= probs.sum()
    draws = tsamp.sample_top_k(
        torch.Generator().manual_seed(3), _t(np.tile(base, (n, 1))), k, inv_temp, top_p=top_p
    )
    counts = _counts(draws, 10)
    assert set(np.nonzero(counts)[0]) == set(np.nonzero(probs)[0])
    _assert_4sigma(counts, probs)
