"""coati_tpu_torch point-cloud path against coati_tpu on the CPU: the plain
version of the message kernel K3 (against the JAX reference and the JAX
kernel's own CPU dispatch), the plain version of its backward K4 (against
jax.grad, torch.autograd and the TPU backward kernel's body in interpret
mode), the gradients of the EGNN, instance norm, the cubic cutoff, the EGNN
forward at 2 layers x 32 hidden with ragged atom counts and every option,
and encode_points through weights carried across by convert.py.

Inputs come from numpy seeds and go to both packages. Tolerance atol 3e-5,
rtol 1e-4 (float32 summation order) unless a line says why; the JAX side
runs at precision="highest"."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from coati_tpu.models import coati as jco
from coati_tpu.models import egnn as jegnn
from coati_tpu.models.io import params_to_state
from coati_tpu.ops import layers as jlayers
from coati_tpu.ops.pallas import egnn_messages as jmsg

from coati_tpu_torch.common import periodic_table as tpt
from coati_tpu_torch.models import coati as tco
from coati_tpu_torch.models import egnn as tegnn
from coati_tpu_torch.models.convert import state_from_coati_tpu
from coati_tpu_torch.ops import egnn_messages as plain
from coati_tpu_torch.ops import layers as tlayers
from coati_tpu_torch.ops.kernels import egnn_messages as kmsg

from tests.torch_port_helpers import assert_gradients_match, jax_gradients_by_name, model_pair
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ATOL, RTOL = 3e-5, 1e-4


def _close(mine, ref, atol=ATOL, rtol=RTOL):
    mine = mine.detach().float().numpy() if isinstance(mine, torch.Tensor) else mine
    np.testing.assert_allclose(mine, np.asarray(ref, np.float32), atol=atol, rtol=rtol)


def _t(x):
    return torch.tensor(np.asarray(x))


# ------------------------------------------------------- the message kernel


def _message_inputs(b, n, hm, seed, live=None):
    """(a, c, d2, w, wd, b1, w2, b2) as numpy; `live` gives each molecule's
    atom count: pairs with a padding atom, and self pairs, get w = 0."""
    rng = np.random.default_rng(seed)
    a, c = (rng.normal(size=(b, n, hm)).astype(np.float32) for _ in range(2))
    d2 = rng.uniform(0.5, 25.0, size=(b, n, n)).astype(np.float32)
    w = rng.uniform(0.0, 1.0, size=(b, n, n)).astype(np.float32)
    w *= rng.uniform(size=(b, n, n)) < 0.7  # partners beyond the cutoff
    w *= 1.0 - np.eye(n, dtype=np.float32)
    if live is not None:
        mask = (np.arange(n)[None, :] < np.asarray(live)[:, None]).astype(np.float32)
        w *= mask[:, :, None] * mask[:, None, :]
    wd, b1, b2 = (0.3 * rng.normal(size=(hm,)).astype(np.float32) for _ in range(3))
    w2 = (rng.normal(size=(hm, hm)) / np.sqrt(hm)).astype(np.float32)
    return a, c, d2, w.astype(np.float32), wd, b1, w2, b2


def _jax_reference(args):
    with jax.default_matmul_precision("highest"):
        return jmsg.egnn_messages_reference(*(jnp.asarray(x) for x in args))


@pytest.mark.parametrize(
    "b,n,hm,live",
    [(3, 11, 32, None), (4, 16, 128, (16, 9, 1, 0)), (2, 7, 20, (7, 3))],
    ids=["dense", "ragged_with_all_padding_row", "odd_width"],
)
def test_plain_messages_match_jax_reference_and_jax_kernel_dispatch(b, n, hm, live):
    """The plain version of K3 against egnn_messages_reference and against
    egnn_messages, which on the CPU dispatches to that reference (the
    Pallas body has no interpret switch; the JAX package's own tests run it
    the same way). The wrapper on CPU tensors is the plain version."""
    args = _message_inputs(b, n, hm, seed=b + n, live=live)
    targs = [_t(x) for x in args]
    mine = plain.egnn_messages(*targs)
    _close(mine, _jax_reference(args))
    with jax.default_matmul_precision("highest"):
        _close(mine, jmsg.egnn_messages(*(jnp.asarray(x) for x in args)))
    before = kmsg.egnn_messages.launches
    _close(kmsg.egnn_messages(*targs), mine.numpy(), atol=0, rtol=0)
    assert kmsg.egnn_messages.launches == before
    if live is not None:  # padding atoms and an all-padding molecule get zeros
        for row, count in enumerate(live):
            assert not mine[row, count:].any()


def test_plain_messages_chunking_and_bf16_product():
    """Walking the batch in chunks changes nothing; the bf16 mode rounds
    e1 and w2 to bf16 before the product and accumulates in float32, which
    moves the result by bf16's rounding (2^-8 relative per factor), not
    more."""
    args = [_t(x) for x in _message_inputs(5, 9, 32, seed=3, live=(9, 9, 4, 6, 2))]
    whole = plain.egnn_messages(*args)
    one_by_one = plain.egnn_messages(*args, chunk_bytes=1)
    _close(one_by_one, whole.numpy(), atol=1e-6, rtol=1e-6)
    rounded = plain.egnn_messages(*args, mm_dtype=torch.bfloat16)
    assert rounded.dtype == torch.float32
    diff = (rounded - whole).abs().max().item()
    assert 0 < diff < 2.0**-6 * whole.abs().max().item()
    with pytest.raises(TypeError):
        plain.egnn_messages(*args, mm_dtype=torch.float16)


def test_plain_messages_are_differentiable():
    """Autograd through the plain version gives the gradients of the JAX
    reference (the plain backward K4 is held to both further down)."""
    args = _message_inputs(2, 6, 16, seed=4, live=(6, 4))
    targs = [_t(x) for x in args]
    for i in (0, 1, 4, 5, 6, 7):
        targs[i].requires_grad_(True)
    g = np.random.default_rng(5).normal(size=(2, 6, 16)).astype(np.float32)
    (plain.egnn_messages(*targs) * _t(g)).sum().backward()

    def loss(a, c, wd, b1, w2, b2):
        d2, w = jnp.asarray(args[2]), jnp.asarray(args[3])
        return jnp.sum(jmsg.egnn_messages_reference(a, c, d2, w, wd, b1, w2, b2) * g)

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss, argnums=range(6))(*(jnp.asarray(args[i]) for i in (0, 1, 4, 5, 6, 7)))
    for i, ref in zip((0, 1, 4, 5, 6, 7), grads):
        _close(targs[i].grad, ref, atol=1e-4)  # sums over all pairs of the batch


def test_message_wrapper_refuses_what_the_kernel_does_not_take():
    meta = torch.device("meta")
    a = torch.empty(2, 5, 8, device=meta)
    p = torch.empty(2, 5, 5, device=meta)
    v, m = torch.empty(8, device=meta), torch.empty(8, 8, device=meta)
    with pytest.raises(ValueError, match="CUDA"):
        kmsg._check_inputs(a, a, p, p, v, v, m, v, torch.float32)
    with pytest.raises(ValueError, match="shape"):
        kmsg._check_inputs(a, a, p[:, :4], p, v, v, m, v, torch.float32)
    with pytest.raises(TypeError, match="mm_dtype"):
        kmsg._check_inputs(a, a, p, p, v, v, m, v, torch.float16)


# ------------------------------------- K3's bf16-product body (tensor cores)


@pytest.mark.parametrize("hm,padded", [(20, 64), (64, 64), (100, 128), (136, 192), (200, 256),
                                       (256, 256), (257, 0)])
def test_message_forward_work_split_and_shared_memory(hm, padded):
    """K3's bf16 body: W2 and the e1 tiles are Hm rounded up to 64 wide
    (Hm above 256 is refused), a warp owns 16 columns, the work items are
    (molecule, 8 atoms), and the scratch holds an int64 cost an item. Its
    shared memory holds W2 and two 64-pair e1 tiles in bf16, the 8 ranges'
    first and last sums (the item's 8 rows of w while its pairs are listed),
    the item's a rows, its pair list, two chunks' row atoms and weights and
    24 counters: inside one block's 227 KB at the points path's and the
    trainer's N 128 and Hm 256, and at N 130. The Python helpers mirror
    csrc/egnn_messages.cu."""
    source = (kmsg.build.CSRC_DIR / "egnn_messages.cu").read_text()
    assert f"constexpr int kMaxHm = {kmsg.FWD_MAX_HM};" in source
    assert kmsg.fwd_padded_width(hm) == padded
    if not padded:  # the wrapper raises before it builds anything
        return
    assert kmsg.fwd_work_split(1024, 128, hm) == {
        "items": 1024 * 16, "padded_width": padded, "warps": padded // 16,
        "scratch_int64": 1024 * 16}
    assert kmsg.fwd_work_split(3, 11, hm)["items"] == 3 * 2
    w2, tiles = 2 * padded * padded, 2 * 2 * 64 * padded
    sums = 4 * 2 * 8 * padded  # 2 x 8 x 128 floats: the item's w fits in it at N 128
    fixed = 4 * (8 * padded + 8 * 128 + 2 * 2 * 64 + 3 * 8)
    assert kmsg.fwd_smem_bytes(128, hm) == w2 + tiles + sums + fixed
    assert kmsg.fwd_smem_bytes(130, hm) <= kmsg.MAX_SHARED_BYTES
    # two more atoms: the pair list grows, and at Hp 64 the w rows outgrow the sums
    assert kmsg.fwd_smem_bytes(130, hm) - kmsg.fwd_smem_bytes(128, hm) == (
        4 * 8 * 2 + (4 * 8 * 2 if padded == 64 else 0))
    if hm == 256:
        assert kmsg.fwd_smem_bytes(128, hm) == 226400


def test_message_wrapper_refuses_bf16_above_256_before_building(monkeypatch):
    """The bf16 body keeps W2 in shared memory: the wrapper refuses Hm 257
    in that mode before it builds or loads anything; the float32 body takes
    that width (these meta tensors then fail the device check)."""
    def no_build(*args, **kwargs):
        raise AssertionError("the wrapper built a library")

    monkeypatch.setattr(kmsg.build, "load", no_build)
    meta = torch.device("meta")
    hm = kmsg.FWD_MAX_HM + 1
    a = torch.empty(2, 5, hm, device=meta)
    p = torch.empty(2, 5, 5, device=meta)
    v, m = torch.empty(hm, device=meta), torch.empty(hm, hm, device=meta)
    before = kmsg.egnn_messages.launches
    with pytest.raises(ValueError, match="Hm <= 256, got 257"):
        kmsg._forward(a, a, p, p, v, v, m, v, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        kmsg._forward(a, a, p, p, v, v, m, v, torch.float32)
    assert kmsg.egnn_messages.launches == before


def _emulate_bf16_body(a, c, d2, w, wd, b1, w2, b2):
    """K3's bf16 body (csrc/egnn_messages.cu) in torch, in its order of
    products and sums: per work item (molecule, 8 atoms) the live pairs by
    atom, then partner, cut into 8 ranges of ceil(P / 8); e1 = silu(((a + c)
    + d2 wd) + b1) rounded to bf16, z2 = e1 W2 (bf16 W2, float32 sums), m = w
    silu(z2 + b2); each range sums its pairs in order, atom by atom; an atom
    wholly inside a range is written when its run ends, the first and last
    atom of each range are added over the ranges in range order; atoms
    without a live pair get zero."""
    a, c, d2, w, wd, b1, w2, b2 = (torch.as_tensor(x, dtype=torch.float32)
                                   for x in (a, c, d2, w, wd, b1, w2, b2))
    b_sz, n, hm = a.shape
    w2r = w2.to(torch.bfloat16).float()
    out = torch.full((b_sz, n, hm), float("nan"))
    for b in range(b_sz):
        for i0 in range(0, n, 8):
            rows = min(8, n - i0)
            live = [(il, j) for il in range(rows) for j in range(n) if w[b, i0 + il, j] != 0]
            out[b, i0:i0 + rows] = 0.0
            if not live:
                continue
            il_ix = torch.tensor([il for il, _ in live])
            j_ix = torch.tensor([j for _, j in live])
            z1 = ((a[b, i0 + il_ix] + c[b, j_ix]) + d2[b, i0 + il_ix, j_ix, None] * wd) + b1
            e1 = torch.nn.functional.silu(z1).to(torch.bfloat16).float()
            msg = w[b, i0 + il_ix, j_ix, None] * torch.nn.functional.silu(e1 @ w2r + b2)
            span = -(-len(live) // 8)  # pairs a range; a chunk takes 8 of each
            ends = {}  # (range, "first" | "last") -> (atom, sum)
            for g in range(8):
                runs = []  # (atom, running sum in list order)
                for p in range(g * span, min(len(live), (g + 1) * span)):
                    if not runs or runs[-1][0] != live[p][0]:
                        runs.append([live[p][0], torch.zeros(hm)])
                    runs[-1][1] = runs[-1][1] + msg[p]
                for k, (il, total) in enumerate(runs):
                    if k == 0:
                        ends[g, "first"] = (il, total)
                    elif k == len(runs) - 1:
                        ends[g, "last"] = (il, total)
                    else:  # wholly inside the range
                        out[b, i0 + il] = total
            for il in range(rows):
                pieces = [ends[g, end][1] for g in range(8) for end in ("first", "last")
                          if ends.get((g, end), (None,))[0] == il]
                if pieces:
                    total = torch.zeros(hm)
                    for piece in pieces:
                        total = total + piece
                    out[b, i0 + il] = total
    return out


def _pallas_forward_interpret(a, c, d2, w, wd, b1, w2, b2, mm_dtype):
    """The TPU forward kernel's body under pl.pallas_call in interpret mode,
    with the block layout of the package's _fwd_pallas (which has no
    interpret switch) on inputs padded by its _pad_all."""
    b_sz, n, hm = a.shape
    a_p, c_p, d2_p, w_p, tile_b = jmsg._pad_all(a, c, d2, w, tile_fn=jmsg.fwd_tile_b)
    bp, ni, nj = a_p.shape[0], a_p.shape[1], c_p.shape[1]

    def rows(r, width):
        return pl.BlockSpec((tile_b, r, width), lambda i: (i, 0, 0))

    def shared(r):
        return pl.BlockSpec((r, hm), lambda i: (0, 0))

    out = pl.pallas_call(
        functools.partial(jmsg._fwd_kernel, mm_dtype=mm_dtype, tile_b=tile_b,
                          subtiles=tuple(jmsg._j_subtiles(nj))),
        grid=(bp // tile_b,),
        in_specs=[rows(ni, hm), rows(nj, hm), rows(ni, nj), rows(ni, nj), shared(1), shared(1),
                  shared(hm), shared(1)],
        out_specs=rows(ni, hm),
        out_shape=jax.ShapeDtypeStruct((bp, ni, hm), jnp.float32),
        interpret=True,
    )(a_p, c_p, d2_p, w_p, wd.reshape(1, hm), b1.reshape(1, hm), w2, b2.reshape(1, hm))
    return out[:b_sz, :n]


@pytest.mark.parametrize(
    "b,n,hm,live",
    [(3, 11, 32, (11, 1, 0)), (2, 20, 72, (20, 13)), (2, 9, 136, (9, 6))],
    ids=["lone_atom_and_all_padding", "several_chunks_odd_width", "wide_odd"],
)
def test_message_bf16_body_emulation_matches_plain_and_tpu_kernel(b, n, hm, live):
    """The bf16 body's order of products and sums, emulated, against the
    plain version's bf16-product mode and against the TPU kernel's body in
    interpret mode (bf16 MXU inputs): within half the chip's tolerance of
    1e-3 x max(1, max |plain|). w has dead rows and columns, a ragged live
    prefix, a lone atom and an all-padding molecule; atoms without a live
    pair come out exactly zero."""
    args = _holes(_message_inputs(b, n, hm, seed=b * n + hm, live=live))
    mine = _emulate_bf16_body(*args)
    ref = plain.egnn_messages(*(_t(x) for x in args), mm_dtype=torch.bfloat16)
    tpu = _pallas_forward_interpret(*(jnp.asarray(x) for x in args), jnp.bfloat16)
    tol = 0.5e-3 * max(1.0, float(ref.abs().max()))
    _close(mine, ref.numpy(), atol=tol, rtol=0)
    _close(mine, np.asarray(tpu), atol=tol, rtol=0)
    dead = args[3].sum(-1) == 0
    assert dead.any() and not mine[torch.as_tensor(dead)].any()
    if n == 20:  # items of 8 atoms with up to 19 partners each: more than one chunk of 64
        assert max((args[3][m, i0:i0 + 8] != 0).sum() for m in range(b) for i0 in (0, 8)) > 64


# ------------------------------------------------- the message backward (K4)

GRAD_ARGS = (0, 1, 4, 5, 6, 7)  # a, c, wd, b1, w2, b2: d2 and w get no gradient


def _holes(args):
    """The same inputs with a dead row i, a dead column j and one molecule
    whose live pairs are a ragged prefix, beside what `live` already cut."""
    args = [np.array(x) for x in args]
    w = args[3]
    w[0, 2, :] = 0.0
    w[0, :, 4] = 0.0
    for i in range(w.shape[1]):
        w[-1, i, max(0, w.shape[2] - 1 - i):] = 0.0
    return args


def _jax_message_grads(fn, args, g):
    def loss(a, c, wd, b1, w2, b2):
        return jnp.sum(fn(a, c, jnp.asarray(args[2]), jnp.asarray(args[3]), wd, b1, w2, b2) * g)

    with jax.default_matmul_precision("highest"):
        return jax.grad(loss, argnums=range(6))(*(jnp.asarray(args[i]) for i in GRAD_ARGS))


@pytest.mark.parametrize(
    "b,n,hm,live",
    [(3, 11, 32, None), (4, 16, 128, (16, 9, 1, 0)), (2, 7, 20, (7, 3))],
    ids=["dense", "ragged_with_all_padding_row", "odd_width"],
)
def test_plain_messages_backward_matches_jax_grad_and_autograd(b, n, hm, live):
    """The plain version of K4, all six gradients, against jax.grad through
    the JAX kernel's entry point (on the CPU the VJP of its reference) and
    against torch.autograd through the plain K3; w has dead rows, dead
    columns and a ragged live prefix. atol 1e-4, rtol 1e-3 as
    tests/test_pallas_egnn.py: the parameter gradients sum over every pair."""
    args = _holes(_message_inputs(b, n, hm, seed=b * n, live=live))
    g = np.random.default_rng(hm).normal(size=(b, n, hm)).astype(np.float32)
    targs = [_t(x) for x in args]
    mine = plain.egnn_messages_backward(*targs, _t(g))
    assert all(x.dtype == torch.float32 for x in mine)
    for x, ref in zip(mine, _jax_message_grads(jmsg.egnn_messages, args, g)):
        _close(x, ref, atol=1e-4, rtol=1e-3)
    leaves = [x.clone().requires_grad_(i in GRAD_ARGS) for i, x in enumerate(targs)]
    auto = torch.autograd.grad(plain.egnn_messages(*leaves), [leaves[i] for i in GRAD_ARGS], _t(g))
    for x, ref in zip(mine, auto):
        _close(x, ref.numpy(), atol=1e-4, rtol=1e-3)
    w = targs[3]
    assert not mine[0][w.abs().sum(-1) == 0].any()  # da of atoms i without a live pair
    assert not mine[1][w.abs().sum(-2) == 0].any()  # dc of atoms j without a live pair
    rows = plain.egnn_messages_backward(*targs, _t(g), chunk_bytes=1)
    for x, y in zip(mine, rows):  # molecule by molecule: the parameter sums take another order
        _close(y, x.numpy(), atol=1e-4, rtol=1e-4)


def test_plain_messages_backward_bf16_product():
    """mm_dtype bfloat16 rounds e1, w2 and dz2 to bf16 before the three
    products. On the CPU the JAX package's egnn_messages_bf16 differentiates
    its float32 reference, so the comparison allows bf16's rounding of each
    factor: 2^-6 of every gradient's largest entry."""
    args = _holes(_message_inputs(3, 10, 32, seed=7, live=(10, 6, 10)))
    g = np.random.default_rng(8).normal(size=(3, 10, 32)).astype(np.float32)
    targs = [_t(x) for x in args]
    mine = plain.egnn_messages_backward(*targs, _t(g), mm_dtype=torch.bfloat16)
    exact = plain.egnn_messages_backward(*targs, _t(g))
    for x, full, ref in zip(mine, exact, _jax_message_grads(jmsg.egnn_messages_bf16, args, g)):
        assert x.dtype == torch.float32 and not torch.equal(x, full)
        _close(x, ref, atol=2.0**-6 * float(np.abs(ref).max()), rtol=0)
    with pytest.raises(TypeError):
        plain.egnn_messages_backward(*targs, _t(g), mm_dtype=torch.float16)


def _pallas_backward_interpret(a, c, d2, w, wd, b1, w2, b2, g, mm_dtype):
    """The TPU backward kernel's body under pl.pallas_call in interpret
    mode, with the block layout of the package's _bwd_pallas (which has no
    interpret switch) on inputs padded by its _pad_all."""
    b_sz, n, hm = a.shape
    a_p, c_p, d2_p, w_p, g_p, tile_b = jmsg._pad_all(a, c, d2, w, g, tile_fn=jmsg.bwd_tile_b)
    bp, ni, nj = a_p.shape[0], a_p.shape[1], c_p.shape[1]

    def rows(r, width):
        return pl.BlockSpec((tile_b, r, width), lambda i: (i, 0, 0))

    def shared(r):
        return pl.BlockSpec((r, hm), lambda i: (0, 0))

    da, dc, dwd, db1, dw2, db2 = pl.pallas_call(
        functools.partial(jmsg._bwd_kernel, mm_dtype=mm_dtype, tile_b=tile_b,
                          subtiles=tuple(jmsg._j_subtiles(nj))),
        grid=(bp // tile_b,),
        in_specs=[rows(ni, hm), rows(nj, hm), rows(ni, nj), rows(ni, nj), shared(1), shared(1),
                  shared(hm), shared(1), rows(ni, hm)],
        out_specs=[rows(ni, hm), rows(nj, hm), shared(1), shared(1), shared(hm), shared(1)],
        out_shape=[jax.ShapeDtypeStruct(shape, jnp.float32) for shape in (
            (bp, ni, hm), (bp, nj, hm), (1, hm), (1, hm), (hm, hm), (1, hm))],
        interpret=True,
    )(a_p, c_p, d2_p, w_p, wd.reshape(1, hm), b1.reshape(1, hm), w2, b2.reshape(1, hm), g_p)
    return da[:b_sz, :n], dc[:b_sz, :n], dwd[0], db1[0], dw2, db2[0]


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_plain_messages_backward_matches_pallas_backward_kernel_body(mm):
    """The plain K4 against the TPU kernel body itself, in both modes. In
    float32 the order of sums differs; in the bf16 mode both round e1, w2 and
    dz2 at the same points, and a last-bit difference of a SiLU now and then
    moves one of them to the neighbouring bf16 value (2^-8 relative)."""
    args = _holes(_message_inputs(2, 12, 128, seed=9, live=(12, 7)))
    g = np.random.default_rng(10).normal(size=(2, 12, 128)).astype(np.float32)
    ref = _pallas_backward_interpret(*(jnp.asarray(x) for x in args), jnp.asarray(g),
                                     getattr(jnp, mm))
    mine = plain.egnn_messages_backward(*(_t(x) for x in args), _t(g),
                                        mm_dtype=getattr(torch, mm))
    for x, r in zip(mine, ref):
        if mm == "float32":
            _close(x, r, atol=1e-4, rtol=1e-3)
        else:
            _close(x, r, atol=2.0**-8 * float(np.abs(r).max()), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_message_wrapper_is_differentiable_and_geometry_gets_no_gradient(dtype):
    """On CPU tensors the wrapper's Function runs the plain K3 and K4: an
    input that requires grad no longer raises, the six gradients arrive in
    the inputs' dtypes and equal the plain backward's, d2 and w get none, and
    nothing is launched."""
    args = [_t(x).to(dtype) for x in _message_inputs(2, 6, 16, seed=11, live=(6, 4))]
    for x in args:
        x.requires_grad_(True)
    g = _t(np.random.default_rng(12).normal(size=(2, 6, 16)).astype(np.float32)).to(dtype)
    before = (kmsg.egnn_messages.launches, kmsg.egnn_messages.bwd_launches)
    out = kmsg.egnn_messages(*args, mm_dtype=dtype)
    assert out.grad_fn is not None and out.dtype == dtype
    out.backward(g)
    assert (kmsg.egnn_messages.launches, kmsg.egnn_messages.bwd_launches) == before
    assert args[2].grad is None and args[3].grad is None
    ref = plain.egnn_messages_backward(*(x.detach() for x in args), g, mm_dtype=dtype)
    for i, r in zip(GRAD_ARGS, ref):
        assert args[i].grad.dtype == dtype
        _close(args[i].grad, r.to(dtype).float().numpy(), atol=0, rtol=0)


def test_message_backward_wrapper_takes_no_transposed_w2_and_is_the_plain_backward():
    """The K4 wrapper passes W2 once: the kernel reads W2^T from the same
    shared tile (bf16 mode) or column by column (float32 mode), so neither
    the C entry point nor the wrapper builds a transposed copy. On CPU tensors
    it returns the plain backward exactly, in both modes, and launches
    nothing."""
    import inspect

    source = (kmsg.build.CSRC_DIR / "egnn_messages_bwd.cu").read_text()
    entry = source[source.index('extern "C" int egnn_messages_bwd('):]
    assert "w2t" not in entry and "w2t" not in inspect.getsource(kmsg.egnn_messages_backward)
    # 9 inputs, 6 outputs, the bf16 body's scratch and counters, then ints
    assert kmsg._BWD_ARGTYPES.count(kmsg.ctypes.c_void_p) == 9 + 6 + 2 + 1
    args = _holes(_message_inputs(2, 9, 24, seed=13, live=(9, 5)))
    g = np.random.default_rng(14).normal(size=(2, 9, 24)).astype(np.float32)
    targs = [_t(x) for x in args]
    before = kmsg.egnn_messages.bwd_launches
    for mm in (torch.float32, torch.bfloat16):
        mine = kmsg.egnn_messages_backward(*targs, _t(g), mm_dtype=mm)
        ref = plain.egnn_messages_backward(*targs, _t(g), mm_dtype=mm)
        assert all(torch.equal(x, r) for x, r in zip(mine, ref))
    assert kmsg.egnn_messages.bwd_launches == before


@pytest.mark.parametrize("hm,slice_width", [(20, 32), (128, 32), (129, 64), (256, 64), (257, 0)])
def test_message_backward_work_split_and_shared_memory(hm, slice_width):
    """K4's bf16 body: clusters of 4 blocks, each owning a quarter of the
    columns of W2 rounded up to 128 or 256 (Hm above 256 is refused), with
    16 warps at 64 columns and 8 at 32; its
    shared memory holds W2's two slices and the e1 and dz2 tiles of a chunk
    in bf16, two chunks' slices of c in float32, and the item's w, d2 and
    pair list, inside one block's 227 KB at the trainer's N 128 and Hm 256;
    the scratch holds a dW2 and three vectors a cluster."""
    assert kmsg.bwd_slice_width(hm) == slice_width
    if not slice_width:  # the wrapper raises before it builds anything
        return
    hp = 4 * slice_width
    warps = 16 if slice_width == 64 else 8
    split = kmsg.bwd_work_split(160, 128, hm, clusters=32)
    assert split == {"items": 160 * 16, "slice_width": slice_width, "padded_width": hp,
                     "blocks": 128, "warps": warps,
                     "scratch_floats": 32 * (hp * hp + 3 * hp) + 2 * 160 * 16}
    assert kmsg.bwd_work_split(3, 11, hm, 1)["items"] == 3 * 2
    w2_slices, tiles = 2 * (2 * hp * slice_width), 2 * (2 * 64 * hp)
    c_buffers = 2 * 64 * (slice_width + 8)  # two chunks' rows of c, padded by 8 floats
    rows = (2 + 32 * warps // slice_width) * 8 * slice_width  # a, g and the walk groups' da
    fixed = 4 * (c_buffers + rows + 3 * slice_width + 2 * 4 * 64)
    assert kmsg.bwd_smem_bytes(128, hm) == w2_slices + tiles + fixed + 3 * 4 * 8 * 128
    assert kmsg.bwd_smem_bytes(128, hm) <= kmsg.MAX_SHARED_BYTES
    assert kmsg.bwd_smem_bytes(130, hm) == kmsg.bwd_smem_bytes(128, hm) + 3 * 4 * 8 * 2


# ------------------------------------------------- gradients of the encoder

UNUSED_BY_POINTS = ("xformer.", "smiles_to_clip.", "point_clip_to_special_tokens.", ".coord_mlp.")


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_egnn_forward_gradients_match_jax(fused, remat):
    """Gradients of a scalar loss of egnn_forward with respect to every
    parameter of the encoder, through the message Function (fused) and
    through the dense path, with and without rematerialization."""
    jparams, jcfg, model, tcfg = model_pair(seed=13, n_layer_e3gnn=2, egnn_remat=remat)
    atoms, coords = _points(len(COUNTS), 12, seed=14, counts=COUNTS)
    g = np.random.default_rng(15).normal(size=(len(COUNTS), 16)).astype(np.float32)
    jecfg = jcfg.egnn_config.replace(fused_messages=fused)
    tecfg = tcfg.egnn_config.replace(fused_messages=fused)
    assert tecfg.remat == remat and jecfg.remat == remat

    def jloss(params):
        pooled = jegnn.egnn_forward(params.point_encoder, jecfg, jnp.asarray(atoms),
                                    jnp.asarray(coords))
        return jnp.sum(pooled * g)

    pooled = tegnn.egnn_forward(model.point_encoder, tecfg, _t(atoms), _t(coords))
    (pooled * _t(g)).sum().backward()
    compared = assert_gradients_match(model.named_parameters(), jax.grad(jloss)(jparams),
                                      unused=UNUSED_BY_POINTS + ("point_to_clip.",))
    assert compared == 2 * 8 + 2 + 4  # two layers' edge and node MLPs, embedding, decoder


def test_encode_points_bf16_leaves_float32_gradients_on_the_masters():
    """Under bf16 compute the cast of the parameters is one autograd
    follows: a loss through encode_points leaves a non-zero float32 .grad on
    every master parameter that the JAX gradient is non-zero for."""
    jparams, jcfg, model, tcfg = model_pair(seed=16, n_layer_e3gnn=2)
    atoms, coords = _points(4, 10, seed=17, counts=(10, 8, 5, 3))
    g = np.random.default_rng(18).normal(size=(4, 32)).astype(np.float32)
    half = tco.encode_points(model, tcfg.replace(dtype="bfloat16"), _t(atoms), _t(coords))
    assert half.dtype == torch.bfloat16
    (half.float() * _t(g)).sum().backward()
    jgrads = jax.grad(lambda p: jnp.sum(
        jco.encode_points(p, jcfg, jnp.asarray(atoms), jnp.asarray(coords)) * g))(jparams)
    ref = jax_gradients_by_name(jgrads)
    reached = 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32
        if not ref[name].any():
            assert p.grad is None or not p.grad.any(), name
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32 and p.grad.any(), name
        # bf16 activations five roundings deep: the direction holds
        cos = torch.nn.functional.cosine_similarity(p.grad.flatten(), _t(ref[name]).flatten(), dim=0)
        assert cos > 0.95, (name, float(cos))
        reached += 1
    assert reached == 2 * 8 + 2 + 4 + 4  # the encoder's, and the projection's LayerNorm and Linear


# ------------------------------------------------------------ small pieces


def test_instance_norm_lastdim_matches_jax():
    x = np.random.default_rng(0).normal(2.0, 3.0, size=(3, 5, 32)).astype(np.float32)
    _close(tlayers.instance_norm_lastdim(_t(x)), jlayers.instance_norm_lastdim(jnp.asarray(x)))
    half = tlayers.instance_norm_lastdim(_t(x).bfloat16())
    assert half.dtype == torch.bfloat16  # statistics in float32, cast back
    _close(half, jlayers.instance_norm_lastdim(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32),
           atol=2.0**-6)  # one bf16 rounding of values up to 4


def test_cubic_cutoff_at_zero_inside_at_and_past_the_cutoff():
    x = np.asarray([-1.0, 0.0, 1e-3, 1.0, 2.5, 4.999, 5.0, 5.001, 40.0], np.float32)
    mine = tegnn.cubic_cutoff(_t(x), 5.0)
    _close(mine, jegnn.cubic_cutoff(jnp.asarray(x), 5.0))
    assert mine[0] == 1.0 and mine[1] == 1.0 and mine[4] == 0.6875
    assert (mine[6:] == 0).all() and (mine[2:6] > 0).all() and (mine[2:6] < 1).all()


def test_one_hot_table_is_the_jax_package_s():
    from coati_tpu.common import periodic_table as jpt

    np.testing.assert_array_equal(tpt.xy_one_hot_full_table(), jpt.xy_one_hot_full_table())
    atoms = np.asarray([[6, 1, 0], [35, 92, 8]])
    np.testing.assert_array_equal(tpt.atoms_to_xy_features(atoms), jpt.atoms_to_xy_features(atoms))
    assert tpt.N_XY_FEATURES == tegnn.N_ONE_HOT == 28
    assert tpt.XY_ONE_HOT_FULL(92) == jpt.XY_ONE_HOT_FULL(92)  # the actinide quirk


# -------------------------------------------------------------- the encoder


def _points(b, n, seed, counts):
    """Ragged molecules: atomic numbers packed before the 0 padding, and
    coordinates a few Angstrom apart so that some pairs pass the cutoff."""
    rng = np.random.default_rng(seed)
    atoms = rng.choice([1, 6, 7, 8, 9, 16, 17, 35], size=(b, n))
    atoms *= np.arange(n)[None, :] < np.asarray(counts)[:, None]
    coords = rng.normal(scale=2.5, size=(b, n, 3)).astype(np.float32)
    return atoms.astype(np.int32), coords


def _egnn_pair(seed=0, **kw):
    """A 2-layer, 32-wide EGNN in both packages, same weights."""
    kwargs = dict(n_layer_e3gnn=2, n_layer_xformer=1, n_hidden_xformer=32, n_hidden_e3nn=32,
                  n_embd_common=32, n_head=2, n_seq=16, n_tok=20, **kw)
    jcfg = jco.CoatiConfig(precision="highest", prefill_kernel="xla", **kwargs)
    jparams = jco.init_coati(jax.random.PRNGKey(seed), jcfg)
    tcfg = tco.CoatiConfig(**kwargs)
    model = tco.CoatiModel(tcfg)
    state = state_from_coati_tpu(params_to_state(jparams), kw.get("old_architecture", False))
    model.load_state_dict(state, strict=True)
    model.requires_grad_(False)
    return jparams, jcfg, model, tcfg


COUNTS = (12, 7, 1, 0, 12)  # a lone atom and an all-padding row among them


@pytest.mark.parametrize(
    "options",
    [
        dict(),
        dict(residual=True),
        dict(torch_emb=True),
        dict(torch_emb=True, residual=True),
    ],
    ids=["plain", "residual", "torch_emb", "torch_emb_residual"],
)
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_egnn_forward_matches_jax(options, fused):
    jparams, jcfg, model, tcfg = _egnn_pair(seed=1, **options)
    atoms, coords = _points(len(COUNTS), 12, seed=2, counts=COUNTS)
    jecfg = jcfg.egnn_config.replace(fused_messages=fused)
    ref = jegnn.egnn_forward(jparams.point_encoder, jecfg, jnp.asarray(atoms), jnp.asarray(coords))
    tecfg = tcfg.egnn_config.replace(fused_messages=fused)
    before = kmsg.egnn_messages.launches
    mine = tegnn.egnn_forward(model.point_encoder, tecfg, _t(atoms), _t(coords))
    assert mine.shape == (len(COUNTS), 32) and kmsg.egnn_messages.launches == before
    _close(mine, ref)
    assert torch.isfinite(mine).all()  # the natoms >= 1 guard on the all-padding row


def test_egnn_forward_gelu_takes_the_dense_path_and_matches_jax(monkeypatch):
    jparams, jcfg, model, tcfg = _egnn_pair(seed=3)
    atoms, coords = _points(len(COUNTS), 12, seed=4, counts=COUNTS)
    jecfg = jcfg.egnn_config.replace(act_fn="GELU")
    ref = jegnn.egnn_forward(jparams.point_encoder, jecfg, jnp.asarray(atoms), jnp.asarray(coords))

    def no_kernel(*args, **kwargs):
        raise AssertionError("GELU reached the fused message kernel")

    monkeypatch.setattr(tegnn, "egnn_messages", no_kernel)
    tecfg = tcfg.egnn_config.replace(act_fn="GELU")
    _close(tegnn.egnn_forward(model.point_encoder, tecfg, _t(atoms), _t(coords)), ref)
    with pytest.raises(ValueError, match="act_fn"):
        tegnn.egnn_forward(model.point_encoder, tecfg.replace(act_fn="ReLU"), _t(atoms), _t(coords))


def test_egnn_fused_path_goes_through_the_message_wrapper(monkeypatch):
    """fused_messages with SiLU calls the K3 wrapper once per layer, with
    the decomposed first edge layer and w2 in the JAX (in, out) layout."""
    _, _, model, tcfg = _egnn_pair(seed=5)
    atoms, coords = _points(3, 8, seed=6, counts=(8, 5, 2))
    calls = []

    def spy(a, c, d2, w, wd, b1, w2, b2, mm_dtype):
        calls.append((a.shape, d2.shape, wd.shape, w2.shape, mm_dtype))
        return plain.egnn_messages(a, c, d2, w, wd, b1, w2, b2, mm_dtype=mm_dtype)

    monkeypatch.setattr(tegnn, "egnn_messages", spy)
    fused = tegnn.egnn_forward(model.point_encoder, tcfg.egnn_config, _t(atoms), _t(coords))
    assert calls == [((3, 8, 32), (3, 8, 8), (32,), (32, 32), torch.float32)] * 2
    dense = tegnn.egnn_forward(
        model.point_encoder, tcfg.egnn_config.replace(fused_messages=False), _t(atoms), _t(coords)
    )
    _close(fused, dense.numpy())


def test_egnn_config_follows_the_jax_package():
    jcfg = jco.CoatiConfig(msg_cutoff_e3nn=4.0, n_hidden_e3nn=64, n_layer_e3gnn=3, residual=True)
    tcfg = tco.CoatiConfig(msg_cutoff_e3nn=4.0, n_hidden_e3nn=64, n_layer_e3gnn=3, residual=True)
    for honor in (False, True):  # the cutoff is 5.0 unless honor_msg_cutoff
        je = jcfg.replace(honor_msg_cutoff=honor).egnn_config
        te = tcfg.replace(honor_msg_cutoff=honor).egnn_config
        for field in ("hidden_nf", "n_layers", "message_cutoff", "instance_norm", "torch_emb",
                      "residual", "act_fn", "dtype", "fused_messages", "in_node_nf"):
            assert getattr(te, field) == getattr(je, field), field
    assert te.message_cutoff == 4.0 and tcfg.egnn_config.message_cutoff == 5.0


@pytest.mark.parametrize("old_architecture", [False, True])
def test_encode_points_with_weights_carried_across(old_architecture):
    """encode_points = EGNN + the point projection, whose LayerNorm is over
    n_hidden_e3nn (here 32 = embed_dim, as in every published config)."""
    jparams, jcfg, model, tcfg = _egnn_pair(seed=7, old_architecture=old_architecture)
    atoms, coords = _points(len(COUNTS), 12, seed=8, counts=COUNTS)
    ref = jco.encode_points(jparams, jcfg, jnp.asarray(atoms), jnp.asarray(coords))
    _close(tco.encode_points(model, tcfg, _t(atoms), _t(coords)), ref)


def test_encode_points_is_zero_without_a_point_encoder():
    _, _, model, tcfg = _egnn_pair(seed=9, use_point_encoder=False)
    assert not hasattr(model, "point_encoder")
    atoms, coords = _points(3, 6, seed=10, counts=(6, 2, 0))
    out = tco.encode_points(model, tcfg, _t(atoms), _t(coords))
    assert out.shape == (3, 32) and not out.any()


def test_encode_points_bf16_stays_near_float32():
    """bf16 compute: d2 and the weights are cast to bf16 before the message
    function, which computes in float32 with a bf16-rounded inner product.
    Five roundings deep, the embedding stays within a few percent of the
    float32 one (cosine > 0.99); this pins the order of casts, not a
    tolerance against JAX, whose CPU path rounds elsewhere."""
    _, _, model, tcfg = _egnn_pair(seed=11)
    atoms, coords = _points(4, 10, seed=12, counts=(10, 8, 5, 3))
    full = tco.encode_points(model, tcfg, _t(atoms), _t(coords))
    half = tco.encode_points(model, tcfg.replace(dtype="bfloat16"), _t(atoms), _t(coords))
    assert half.dtype == torch.bfloat16
    cos = torch.nn.functional.cosine_similarity(full, half.float(), dim=-1)
    assert (cos > 0.99).all(), cos
