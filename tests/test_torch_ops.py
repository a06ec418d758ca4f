"""coati_tpu_torch ops against coati_tpu on the CPU: layers, rotary, the
plain attention functions, the kernels' CPU paths (against the Pallas
kernels in interpret mode), the plain attention backward and the gradients
through the attention wrappers, int8 KV quantization and top-k sampling.

Inputs come from numpy seeds and go to both packages. Shared tolerance,
as in the repo's parity tests: atol 3e-5, rtol 1e-4 (float32 summation
order); lines that differ say why."""

import math

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
from coati_tpu.ops.pallas.packed_attention import _packed_backward as jax_packed_backward
from coati_tpu.ops.pallas.packed_attention import packed_causal_attention as jax_packed

from coati_tpu_torch.models.transformer import quantize_kv
from coati_tpu_torch.ops import attention as tatt
from coati_tpu_torch.ops import layers as tlayers
from coati_tpu_torch.ops import rotary as trot
from coati_tpu_torch.ops import sampling as tsamp
from coati_tpu_torch.ops.kernels import decode_attention as kdecode
from coati_tpu_torch.ops.kernels import flash_attention as kflash
from coati_tpu_torch.ops.kernels import packed_attention as kpacked

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


@pytest.mark.parametrize("t", [3, 37, 128])
def test_packed_cpu_path_matches_pallas_kernel(t):
    """The port's K5f wrapper (plain path on a CPU tensor) against the TPU
    kernel, which selects interpret mode itself on the CPU, at H*Dh = 128
    (which the TPU kernel needs)."""
    q, k, v = (_normal(i, 2, t, 8, 16) for i in (24, 25, 26))
    ref = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = kpacked.packed_causal_attention.launches
    mine = kpacked.packed_causal_attention(_t(q), _t(k), _t(v))
    _close(mine, ref)
    _close(mine, kflash.flash_causal_attention(_t(q), _t(k), _t(v)), atol=0, rtol=0)
    assert kpacked.packed_causal_attention.launches == before


def test_packed_refuses_long_sequences_and_picks_head_groups():
    q = _t(_normal(27, 1, 129, 8, 16))
    with pytest.raises(ValueError, match="T <= 128, got T=129"):
        kpacked.packed_causal_attention(q, q, q)
    with pytest.raises(ValueError, match="T=129"):
        jax_packed(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()), jnp.asarray(q.numpy()))
    meta = torch.empty(2, 8, 4, 16, device="meta")
    with pytest.raises(ValueError, match="packed_causal_attention: q, k, v must lie on one CUDA"):
        kflash.check_qkv(meta, meta, meta, "packed_causal_attention")
    # heads per block: a divisor of H whose staged K and V stay under 28 KB
    # in float32 (rows of Dh + 1 floats) ...
    f32, bf16 = torch.float32, torch.bfloat16
    assert kpacked.head_group(96, 16, 16, f32) == 2
    assert kpacked.head_group(128, 16, 16, f32) == 1
    assert kpacked.head_group(3, 16, 16, f32) == 16
    assert kpacked.head_group(128, 2, 64, f32) == 1  # one head is above it: still one
    for t, h, dh in ((96, 16, 16), (37, 4, 32), (128, 12, 16)):
        g = kpacked.head_group(t, h, dh, f32)
        assert h % g == 0 and (g == 1 or g * 2 * t * (dh + 1) * 4 <= kpacked.GROUP_BYTES[f32])
    # ... and in bf16 under 24 KB (T rounded up to the tensor cores' 16
    # rows) with at most three pairs of 16-row tiles for each of 4 warps
    assert kpacked.staged_bytes(128, 16, bf16) == 8192  # 4 KB a head a tensor
    assert kpacked.staged_bytes(97, 16, bf16) == kpacked.staged_bytes(112, 16, bf16)
    assert [kpacked.tile_pairs(t) for t in (1, 16, 17, 48, 80, 96, 128)] == [1, 1, 1, 2, 3, 3, 4]
    assert kpacked.head_group(96, 16, 16, bf16) == 4
    assert kpacked.head_group(128, 16, 16, bf16) == 2
    assert kpacked.head_group(48, 16, 16, bf16) == 4  # the trainer's batches
    assert kpacked.head_group(80, 16, 16, bf16) == 4
    assert kpacked.head_group(3, 16, 16, bf16) == 8
    assert kpacked.head_group(17, 6, 64, bf16) == 3  # bytes bound it here
    assert kpacked.head_group(128, 2, 64, bf16) == 1  # one head is above it: still one
    for t, h, dh in ((96, 16, 16), (37, 4, 32), (128, 12, 16), (80, 16, 16), (5, 16, 16)):
        g = kpacked.head_group(t, h, dh, bf16)
        per_head = 2 * (-(-t // 16) * 16) * dh * 2
        assert h % g == 0 and g * kpacked.tile_pairs(t) <= 12
        assert g == 1 or g * per_head <= kpacked.GROUP_BYTES[bf16]


def _emulate_k2_bf16(q, k, v):
    """The arithmetic of K2's bf16 tensor-core body (csrc/flash_attention.cu),
    in PyTorch on the CPU: bf16 products summed in float32, 64-key tiles,
    an online softmax in float32 and base 2, the unnormalized P rounded to
    bf16 before P V, float32 accumulation, 1/l at the end, bf16 output."""
    b, t, h, dh = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # (B, H, T, Dh)
    c = math.log2(math.e) / math.sqrt(dh)
    m = torch.full((b, h, t, 1), -math.inf)
    l, acc = torch.zeros(b, h, t, 1), torch.zeros(b, h, t, dh)
    rows = torch.arange(t)[:, None]
    for n0 in range(0, t, 64):
        keys = torch.arange(n0, min(n0 + 64, t))[None, :]
        s = (qf @ kf[:, :, n0:n0 + 64].transpose(-1, -2)).masked_fill(keys > rows, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vf[:, :, n0:n0 + 64]
        m = m_new
    return (acc * (1 / l)).bfloat16().transpose(1, 2)


def _emulate_k5f_bf16(q, k, v):
    """The arithmetic of K5f's bf16 tensor-core body
    (csrc/packed_attention.cu): a row's scores complete, the exact max and
    sum in float32 and base 2, P normalized and then rounded to bf16, P V
    accumulated in float32, bf16 output."""
    _, t, _, dh = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    c = math.log2(math.e) / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = (qf @ kf.transpose(-1, -2)).masked_fill(~causal, -math.inf)
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    p = p * (1 / p.sum(-1, keepdim=True))
    return (p.bfloat16().float() @ vf).bfloat16().transpose(1, 2)


EMULATIONS = {"flash": _emulate_k2_bf16, "packed": _emulate_k5f_bf16}


@pytest.mark.parametrize("t", [3, 65, 128, 250])
@pytest.mark.parametrize("kernel", ["flash", "packed"])
def test_bf16_rounding_points_fit_the_chip_tolerance(kernel, t):
    """The rounding points of the bf16 tensor-core bodies of K2 and K5f,
    emulated on the CPU, against the plain version that chip_smoke.py holds
    the kernels to, within half of its bf16 tolerance (2 bf16 ulps of the
    output scale, 2 * 2^-7 * max |ref|): the rest is left for the order of
    the sums on the card. (K5f takes T <= 128; at T 250 this checks its
    rounding point alone.)"""
    q, k, v = (_t(_normal(70 + i, 4, t, 4, 16)).bfloat16() for i in range(3))
    ref = tatt.causal_attention(q, k, v, torch.float32).float()
    mine = EMULATIONS[kernel](q, k, v).float()
    assert mine.shape == ref.shape
    tol = 0.5 * 2 * 2.0**-7 * float(ref.abs().max())
    assert float((mine - ref).abs().max()) <= tol


@pytest.mark.parametrize("t", [3, 37, 65, 128])
def test_packed_bf16_rounding_point_matches_pallas_kernel(t):
    """K5f's bf16 emulation against the TPU kernel in interpret mode, in
    bf16: both round the normalized P to bf16 before P V and accumulate in
    float32, so they differ by the last float32 bits of P before that
    rounding and by the rounding of the output: within one bf16 ulp of the
    output scale."""
    q, k, v = (_normal(80 + i, 2, t, 8, 16) for i in range(3))
    ref = jax_packed(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    ref = np.asarray(ref.astype(jnp.float32))
    mine = _emulate_k5f_bf16(*(_t(x).bfloat16() for x in (q, k, v)))
    _close(mine, ref, atol=2.0**-7 * np.abs(ref).max(), rtol=0)


def test_bf16_attention_inputs_must_be_16_byte_aligned():
    """The bf16 bodies copy q, k, v 16 bytes at a time: a base pointer or a
    batch or token stride that is not a multiple of 16 bytes is refused, not
    routed elsewhere; the model's views of the fused projection pass, and
    float32 (CUDA cores) takes any strides."""
    b, t, h, dh = 2, 8, 4, 16
    qkv = torch.empty(b, t, 3 * h * dh, dtype=torch.bfloat16, device="meta")
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    kflash.check_aligned(q, k, v)
    odd_token = torch.empty(b, t, h * dh + 4, dtype=torch.bfloat16, device="meta")
    odd_token = odd_token[..., : h * dh].view(b, t, h, dh)  # token stride 68 elements
    with pytest.raises(ValueError, match="bf16 k needs a 16-byte aligned base"):
        kflash.check_aligned(q, odd_token, v)
    shifted = qkv.view(-1)[4:4 + b * t * h * dh].view(b, t, h, dh)  # base 8 bytes in
    with pytest.raises(ValueError, match="packed_causal_attention: bf16 v"):
        kflash.check_aligned(q, k, shifted, "packed_causal_attention")
    kflash.check_aligned(*(x.float() for x in (q, odd_token, shifted)))
    with pytest.raises(ValueError, match="packed_causal_attention_backward: bf16 g"):
        kflash.check_aligned(q, k, v, "packed_causal_attention_backward", shifted)


def test_flash_cpu_path_takes_strided_views():
    """q/k/v split out of the fused qkv projection are strided views; the
    wrapper takes them as they are."""
    b, t, h, dh = 2, 12, 4, 16
    qkv = _t(_normal(23, b, t, 3 * h * dh))
    q, k, v = (x.view(b, t, h, dh) for x in qkv.split(h * dh, dim=-1))
    assert not v.is_contiguous()
    ref = jatt.causal_attention(*(x.contiguous().numpy() for x in (q, k, v)), HIGHEST)
    _close(kflash.flash_causal_attention(q, k, v), ref)


# ------------------------------------------------------ attention backward


def _qkvg(seed, b, t, h, dh):
    return tuple(_normal(seed + i, b, t, h, dh) for i in range(4))


@pytest.mark.parametrize(
    "shape", [(3, 80, 16, 16), (2, 128, 8, 16), (5, 17, 4, 32)], ids=lambda s: "x".join(map(str, s))
)
def test_plain_attention_backward_matches_pallas_backward_kernel(shape):
    """The plain version of K5b against the TPU backward kernel run in
    interpret mode, as tests/test_pallas_packed.py runs it, in float32."""
    q, k, v, g = _qkvg(30, *shape)
    ref = jax_packed_backward(*(jnp.asarray(x) for x in (q, k, v, g)), interpret=True)
    mine = tatt.causal_attention_backward(_t(q), _t(k), _t(v), _t(g))
    for x, r in zip(mine, ref):
        assert x.shape == shape and x.dtype == torch.float32
        _close(x, r)


def test_plain_attention_backward_bf16_matches_pallas_backward_kernel():
    """In bf16 both round dS to bf16 before dq and dk, and P before dv, and
    accumulate in float32; what differs is the last float32 bit of P and dS
    before that rounding, and the rounding of the result: 2 bf16 ulps
    (2^-7 relative) of gradients that reach about 4 here."""
    q, k, v, g = _qkvg(34, 2, 48, 8, 16)
    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)]
    ref = jax_packed_backward(*jargs, interpret=True)
    mine = tatt.causal_attention_backward(*(_t(x).bfloat16() for x in (q, k, v, g)))
    for x, r in zip(mine, ref):
        assert x.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        _close(x, r, atol=2 * 2.0**-7 * np.abs(r).max(), rtol=0)


@pytest.mark.parametrize("shape", [(3, 33, 4, 16), (2, 7, 2, 64)], ids=["T33", "T7"])
def test_plain_attention_backward_matches_autograd_and_is_chunk_invariant(shape):
    """The explicit formula against torch.autograd through the plain
    forward; walking the batch row by row changes nothing."""
    q, k, v, g = (_t(x) for x in _qkvg(40, *shape))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = torch.autograd.grad(tatt.causal_attention(*leaves, torch.float32), leaves, g)
    mine = tatt.causal_attention_backward(q, k, v, g)
    rows = tatt.causal_attention_backward(q, k, v, g, chunk_bytes=1)
    for x, y, r in zip(mine, rows, ref):
        _close(x, r.numpy(), atol=1e-5, rtol=1e-4)
        _close(y, x.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "checkpoint"])
@pytest.mark.parametrize("kernel", ["packed", "flash"])
def test_attention_wrappers_gradients_match_jax(kernel, remat):
    """torch.autograd.grad through the K5f and K2 wrappers on CPU tensors
    (their Functions run the plain backward) against jax.grad through the
    TPU packed kernel in interpret mode, whose VJP is its backward kernel,
    and through the plain JAX attention for K2; also when the call is
    rematerialized. torch.autograd.gradcheck is no option: it wants float64
    and the kernels take float32 and bfloat16 only."""
    from torch.utils.checkpoint import checkpoint

    q, k, v, g = _qkvg(50, 2, 40, 8, 16)
    if kernel == "packed":
        wrapper = kpacked.packed_causal_attention
        jfn = lambda q, k, v: jax_packed(q, k, v, True)  # noqa: E731
    else:
        wrapper = kflash.flash_causal_attention
        jfn = lambda q, k, v: jatt.causal_attention(q, k, v, HIGHEST, jnp.float32)  # noqa: E731
    if remat:
        jfn = jax.checkpoint(jfn)
    ref = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * g), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    # strided views of one fused projection, as the model passes them
    qkv = torch.cat([_t(x).reshape(2, 40, 128) for x in (q, k, v)], dim=-1).requires_grad_(True)
    tq, tk, tv = (x.view(2, 40, 8, 16) for x in qkv.split(128, dim=-1))
    before = (wrapper.launches, kpacked.packed_causal_attention.bwd_launches)
    out = checkpoint(wrapper, tq, tk, tv, use_reentrant=False) if remat else wrapper(tq, tk, tv)
    assert out.grad_fn is not None
    (dqkv,) = torch.autograd.grad(out, qkv, _t(g))
    assert (wrapper.launches, kpacked.packed_causal_attention.bwd_launches) == before
    for x, r in zip(dqkv.split(128, dim=-1), ref):
        _close(x.reshape(2, 40, 8, 16), r)


def _emulate_k5b_bf16(q, k, v, g):
    """The arithmetic of K5b's bf16 tensor-core body
    (csrc/packed_attention_bwd.cu), in PyTorch on the CPU: S = q k^T and
    dP = g v^T in float32 from bf16 inputs; the exact row max, then in base
    2 the unnormalized p, its sum l and sum(p dP); rowsum(P dP) = that sum
    / l from the unrounded float32 values; P = p / l; dS = P (dP - rowsum)
    scale rounded to bf16, P rounded to bf16; dq = dS k, and dk = dS^T q,
    dv = P^T g as float32 sums over the 16-row query tiles in order; bf16
    outputs."""
    _, t, _, dh = q.shape
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (q, k, v, g))  # (B, H, T, Dh)
    scale = 1 / math.sqrt(dh)
    c = scale * math.log2(math.e)
    causal = torch.ones(t, t, dtype=torch.bool).tril()
    s = (qf @ kf.transpose(-1, -2)).masked_fill(~causal, -math.inf)
    p = torch.exp2(s * c - s.amax(-1, keepdim=True) * c)
    dp = gf @ vf.transpose(-1, -2)
    inv = 1 / p.sum(-1, keepdim=True)
    rowsum = (p * dp).sum(-1, keepdim=True) * inv
    pn = p * inv
    ds = ((pn * dp - pn * rowsum) * scale).bfloat16().float()
    pb = pn.bfloat16().float()
    dq = ds @ kf
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, t, 16):
        r = slice(i0, i0 + 16)
        dk = dk + ds[..., r, :].transpose(-1, -2) @ qf[..., r, :]
        dv = dv + pb[..., r, :].transpose(-1, -2) @ gf[..., r, :]
    return tuple(x.bfloat16().transpose(1, 2) for x in (dq, dk, dv))


@pytest.mark.parametrize("t", [1, 15, 16, 17, 48, 80, 127, 128])
def test_k5b_bf16_rounding_points_fit_the_chip_tolerance(t):
    """K5b's bf16 body, emulated on the CPU, against the plain backward that
    chip_smoke.py holds the kernel to, within half of its bf16 tolerance
    (2 bf16 ulps of each output's scale, 2 * 2^-7 * max |ref|): the rest is
    left for the order of the sums on the card."""
    q, k, v, g = (_t(x).bfloat16() for x in _qkvg(90, 3, t, 4, 16))
    for mine, ref in zip(_emulate_k5b_bf16(q, k, v, g), tatt.causal_attention_backward(q, k, v, g)):
        assert mine.shape == ref.shape and mine.dtype == torch.bfloat16
        ref = ref.float()
        tol = 0.5 * 2 * 2.0**-7 * float(ref.abs().max())
        assert float((mine.float() - ref).abs().max()) <= tol


@pytest.mark.parametrize("t", [1, 16, 17, 48, 80, 128])
def test_k5b_bf16_emulation_matches_pallas_backward_kernel(t):
    """K5b's bf16 emulation against the TPU backward kernel in interpret
    mode, in bf16 (H * Dh = 128, which the TPU kernel needs): both round dS
    and P to bf16 before the products and accumulate in float32, so they
    differ by the last float32 bits before those roundings, and by the
    rounding of the outputs: within half of the chip's 2-ulp tolerance."""
    q, k, v, g = _qkvg(94, 2, t, 8, 16)
    refs = jax_packed_backward(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g)),
                               interpret=True)
    mine = _emulate_k5b_bf16(*(_t(x).bfloat16() for x in (q, k, v, g)))
    for x, r in zip(mine, refs):
        r = np.asarray(r.astype(jnp.float32))
        _close(x, r, atol=0.5 * 2 * 2.0**-7 * np.abs(r).max(), rtol=0)


def test_packed_backward_picks_head_groups_by_its_shared_memory():
    """K5b's bf16 blocks stage q, k, v, g and stash P and dS as 16 x 16
    tiles of the lower triangle for each head of their group; the group is
    the largest divisor of H under BWD_GROUP_BYTES with at most three tile
    pairs for each of 4 warps; float32 takes one head a block."""
    f32, bf16 = torch.float32, torch.bfloat16
    # T 128, Dh 16: 4 x 128 x 16 staged and 2 x 36 tiles of 256, in bf16
    assert kpacked.bwd_smem_bytes(128, 16, 1) == 2 * (4 * 128 * 16 + 2 * 36 * 256)
    assert kpacked.bwd_smem_bytes(97, 16, 2) == kpacked.bwd_smem_bytes(112, 16, 2)
    assert kpacked.bwd_smem_bytes(80, 16, 1, f32) == (4 * 80 * 17 + 80 * 81) * 4
    assert kpacked.bwd_head_group(32, 16, 16) == 4  # the trainer's batches
    assert kpacked.bwd_head_group(48, 16, 16) == 2
    assert kpacked.bwd_head_group(80, 16, 16) == 1
    assert kpacked.bwd_head_group(96, 16, 16) == 1
    assert kpacked.bwd_head_group(128, 16, 16) == 1
    assert kpacked.bwd_head_group(128, 2, 64) == 1  # one head is above it: still one
    assert kpacked.bwd_head_group(48, 16, 16, f32) == 1
    for t, h, dh in ((80, 16, 16), (37, 4, 32), (17, 6, 64), (3, 16, 16), (128, 12, 16)):
        grp = kpacked.bwd_head_group(t, h, dh)
        assert h % grp == 0 and grp * kpacked.tile_pairs(t) <= 12
        assert grp == 1 or kpacked.bwd_smem_bytes(t, dh, grp) <= kpacked.BWD_GROUP_BYTES
        assert kpacked.bwd_smem_bytes(t, dh, grp) <= kpacked.MAX_SHARED_BYTES


def test_packed_backward_wrapper_on_the_cpu_is_the_plain_backward():
    """On CPU tensors the K5b wrapper returns the plain backward exactly, in
    both dtypes, and launches nothing."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, g = (_t(x).to(dtype) for x in _qkvg(98, 2, 21, 4, 16))
        before = kpacked.packed_causal_attention.bwd_launches
        mine = kpacked.packed_causal_attention_backward(q, k, v, g)
        for x, r in zip(mine, tatt.causal_attention_backward(q, k, v, g)):
            assert x.dtype == dtype and torch.equal(x, r)
        assert kpacked.packed_causal_attention.bwd_launches == before


def test_packed_backward_refuses_long_sequences():
    q = _t(_normal(60, 1, 129, 8, 16))
    with pytest.raises(ValueError, match="T <= 128, got T=129"):
        kpacked.packed_causal_attention_backward(q, q, q, q)


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
