"""coati_tpu_torch's continuous-batching decode against coati_tpu's on the
CPU: the ring and ragged decode steps (both cache forms, a wrapped ring,
rows at different depths) against decode_step and against coati_tpu's
steps; the engine, greedy, against the port's sampler request by request
and against coati_tpu's engine token for token (uniform and mixed
max_new_tokens, 13 requests over 8 slots, pipelined and not, a COATI2
model); the engine over two devices (["cpu", "cpu"]) against one device
and coati_tpu's engine over make_mesh(2); no decode step once every row is
dead; the late-snapshot harvest; concurrent submission; ContinuousService.

Models: 2 layers, 32 wide, 2 heads, the same weights in both packages
(coati_tpu's init carried across), float32, the JAX side at precision
"highest". Logits atol 3e-5, rtol 1e-4; tokens exactly."""

import copy
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coati_tpu.models import transformer as jt
from coati_tpu.models.io import params_to_state
from coati_tpu.serving.continuous import ContinuousDecoder as JaxDecoder

from coati_tpu_torch.models import transformer as tt
from coati_tpu_torch.models.convert import transformer_state_from_coati_tpu
from coati_tpu_torch.models.sampler import generate_with_injection_batch
from coati_tpu_torch.serving.continuous import ContinuousDecoder, ContinuousService
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STOP, PAD, UNK = 3, 0, 4
PREFIX = [5, UNK, 6]
N_SEQ = 32
BUDGETS = [2, 6, 11, None, 1, 4, None, 9, 3, 29, 7, None, 5]  # 13 requests
J_RING = jax.jit(jt.decode_step_ring, static_argnums=1)
J_RAGGED = jax.jit(jt.decode_step_ragged, static_argnums=1)


def _pair(seed=0, **kw):
    """(jax params, jax config, port module, port config), the same weights."""
    base = dict(n_layer=2, n_embd=32, n_head=2, n_seq=N_SEQ, n_tok=64)
    base.update(kw)
    jcfg = jt.TransformerConfig(precision="highest", **base)
    jparams = jt.init_transformer(jax.random.PRNGKey(seed), jcfg)
    tcfg = tt.TransformerConfig(**base)
    module = tt.SmilesTransformer(tcfg)
    module.load_state_dict(transformer_state_from_coati_tpu(params_to_state(jparams)))
    return jparams, jcfg, module, tcfg


def _injections(n, width=32, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, width)) * 2.0).astype(np.float32)


# ------------------------------------------------------------ decode steps


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_ring_and_ragged_steps_equal_decode_step_at_uniform_positions(kv_dtype):
    """At one position for every row (and clock == position), both steps
    give decode_step's logits and write the cache decode_step writes."""
    _, _, module, cfg = _pair(kv_dtype=kv_dtype)
    b = 5
    token = torch.tensor([7, 1, 30, 12, 63])
    caches = [tt.make_empty_cache(cfg, b) for _ in range(3)]
    with torch.no_grad():
        for pos in range(4):
            ref, caches[0] = tt.decode_step(module, cfg, token, pos, caches[0])
            lpos = torch.full((b,), pos)
            ring, caches[1] = tt.decode_step_ring(module, cfg, token, lpos, pos, caches[1])
            ragged, caches[2] = tt.decode_step_ragged(module, cfg, token, lpos, caches[2])
            for got, cache in ((ring, caches[1]), (ragged, caches[2])):
                hp.close(got, ref.numpy())
                assert torch.equal(cache.data, caches[0].data)
            token = ref.argmax(-1)


def _same_cache(mine, ref):
    """The port's cache against coati_tpu's: float32 within the tolerance;
    int8 within one quantization step (a key a last bit apart may round
    the other way), the scales within the tolerance."""
    if mine.scale is None:
        hp.close(mine.data, np.asarray(ref.data))
    else:
        diff = mine.data.int().numpy() - np.asarray(ref.data).astype(np.int32)
        assert np.abs(diff).max() <= 1
        hp.close(mine.scale, np.asarray(ref.scale))


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_ring_step_equals_coati_tpu_s_across_the_seam(kv_dtype):
    """24 steps over a ring of 16 slots with rows at depths 0, 3, 6 that
    restart at 10: every step's logits equal coati_tpu's decode_step_ring."""
    jparams, jcfg, module, cfg = _pair(kv_dtype=kv_dtype)
    b, width = 3, 16
    jcache = jt.make_empty_cache(jcfg, b, width=width)
    tcache = tt.make_empty_cache(cfg, b, width=width)
    token, lpos = np.array([5, 7, 9]), np.array([0, 3, 6])
    for step in range(24):
        ref, jcache = J_RING(jparams, jcfg, jnp.asarray(token), jnp.asarray(lpos),
                             jnp.asarray(step % width), jcache)
        with torch.no_grad():
            got, tcache = tt.decode_step_ring(module, cfg, torch.as_tensor(token),
                                              torch.as_tensor(lpos), step % width, tcache)
        hp.close(got, np.asarray(ref))
        token, lpos = np.array(jnp.argmax(ref, -1)), (lpos + 1) % 10
    _same_cache(tcache, jcache)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_ragged_step_equals_coati_tpu_s_at_different_depths(kv_dtype):
    jparams, jcfg, module, cfg = _pair(kv_dtype=kv_dtype)
    b = 3
    jcache, tcache = jt.make_empty_cache(jcfg, b), tt.make_empty_cache(cfg, b)
    token, pos = np.array([5, 7, 9]), np.array([0, 2, 5])
    for _ in range(6):
        ref, jcache = J_RAGGED(jparams, jcfg, jnp.asarray(token), jnp.asarray(pos), jcache)
        with torch.no_grad():
            got, tcache = tt.decode_step_ragged(module, cfg, torch.as_tensor(token),
                                                torch.as_tensor(pos), tcache)
        hp.close(got, np.asarray(ref))
        token, pos = np.asarray(jnp.argmax(ref, -1)), pos + 1
    _same_cache(tcache, jcache)


def test_ragged_rows_equal_each_row_decoded_alone():
    """Rows at depths 1, 3, 6 in one ragged pool (retired rows frozen)
    give each row's logits from decoding it alone with decode_step."""
    _, _, module, cfg = _pair()
    depths, tok0 = [1, 3, 6], torch.tensor([9, 17, 40])
    alone = []
    with torch.no_grad():
        for row, depth in enumerate(depths):
            cache, t = tt.make_empty_cache(cfg, 1), tok0[row : row + 1]
            for pos in range(depth):
                logits, cache = tt.decode_step(module, cfg, t, pos, cache)
                t = logits.argmax(-1)
            alone.append(logits[0])
        cache, t = tt.make_empty_cache(cfg, 3), tok0.clone()
        pos, last = torch.zeros(3, dtype=torch.long), torch.zeros(3, cfg.n_tok)
        for step in range(max(depths)):
            active = torch.tensor([step < d for d in depths])
            saved = cache.data.clone()
            logits, cache = tt.decode_step_ragged(module, cfg, t, pos, cache)
            cache.data[:, :, ~active] = saved[:, :, ~active]
            last = torch.where(active[:, None], logits, last)
            t = torch.where(active, logits.argmax(-1), t)
            pos = torch.where(active, pos + 1, pos)
    for row in range(3):
        hp.close(last[row], alone[row].numpy())


# ------------------------------------------------------------------ engine


def _trim(tokens, width):
    """A sampler row (width N_SEQ, [PAD] after [STOP]) cut as the engine's:
    up to [STOP] inclusive."""
    out = [int(x) for x in tokens]
    if STOP in out:
        out = out[: out.index(STOP) + 1]
    return out[:width]


def _budgeted(row, budget):
    return row[: len(PREFIX) + budget] if budget is not None else row


@pytest.fixture(scope="module")
def engine_pair():
    """The transformer of both packages, 13 injections, and coati_tpu's
    engine's greedy tokens for them with uniform and with mixed budgets."""
    jparams, jcfg, module, cfg = _pair(seed=1)
    inj = _injections(13)
    ref = {}
    for mode, budgets in (("uniform", [None] * 13), ("mixed", BUDGETS)):
        eng = JaxDecoder(jparams, jcfg, PREFIX, n_slots=8, stop_token=STOP, pad_token=PAD,
                         inject_token=UNK, k=1, inv_temp=2.0, segment_len=8)
        rids = [eng.submit(inj[i], max_new_tokens=b) for i, b in enumerate(budgets)]
        out = eng.run_until_done()
        ref[mode] = [[int(x) for x in out[r]] for r in rids]
    return module, cfg, inj, ref


def _engine(module, cfg, **kw):
    kw = {**dict(n_slots=8, stop_token=STOP, pad_token=PAD, inject_token=UNK, k=1,
                 inv_temp=2.0, segment_len=8), **kw}
    return ContinuousDecoder(module, cfg, PREFIX, **kw)


@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("mode", ["uniform", "mixed"])
def test_engine_greedy_equals_sampler_and_coati_tpu_s_engine(engine_pair, pipeline, mode):
    """13 requests over 8 slots, slots recycling: every request's tokens
    equal the port sampler's greedy decode of it alone (cut at its budget)
    and coati_tpu's engine's, token for token."""
    module, cfg, inj, ref = engine_pair
    budgets = BUDGETS if mode == "mixed" else [None] * 13
    eng = _engine(module, cfg, pipeline=pipeline)
    rids = [eng.submit(inj[i], max_new_tokens=b) for i, b in enumerate(budgets)]
    out = eng.run_until_done()
    assert sorted(out) == sorted(rids) and eng.n_active == 0 and not eng._free == []
    assert sorted(eng._free) == list(range(8))
    for i, (rid, budget) in enumerate(zip(rids, budgets)):
        got = [int(x) for x in out[rid]]
        assert got == ref[mode][i], f"request {i}"
        alone = generate_with_injection_batch(
            module, cfg, None, PREFIX, torch.as_tensor(inj[i : i + 1]), stop_token=STOP,
            pad_token=PAD, unk_token=UNK, k=1, total_len=N_SEQ)[0]
        want = _budgeted(_trim(alone, N_SEQ), budget)
        if len(want) == N_SEQ:  # a row that never stopped: the sampler forces
            got, want = got[:-1], want[:-1]  # [STOP] last, the engine draws there
        assert got == want, f"request {i}"
        if budget is not None and STOP not in out[rid]:
            assert len(out[rid]) == len(PREFIX) + budget


def test_engine_int8_cache_greedy_equals_coati_tpu_s():
    jparams, jcfg, module, cfg = _pair(seed=2, kv_dtype="int8")
    inj = _injections(5, seed=3)
    jeng = JaxDecoder(jparams, jcfg, PREFIX, n_slots=4, stop_token=STOP, pad_token=PAD,
                      inject_token=UNK, k=1, segment_len=4)
    eng = _engine(module, cfg, n_slots=4, segment_len=4)
    jr = [jeng.submit(x, max_new_tokens=12) for x in inj]
    tr = [eng.submit(x, max_new_tokens=12) for x in inj]
    jout, tout = jeng.run_until_done(), eng.run_until_done()
    for a, b in zip(jr, tr):
        assert [int(x) for x in tout[b]] == [int(x) for x in jout[a]]
        assert list(tout[b][:3]) == PREFIX


def test_engine_coati2_greedy_equals_hcoati_to_2d_batch_and_coati_tpu_s():
    """The server's COATI2 branch: raw h_coati submitted, coati_to_token
    applied at admission; 5 requests over 2 slots, budget 20."""
    from coati_tpu.models import coati2 as j2
    from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer

    from coati_tpu_torch.models import coati2 as t2
    from coati_tpu_torch.models.convert import coati2_state_from_coati_tpu
    from coati_tpu_torch.tokenizers import get_vocab
    from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer

    kw = dict(n_layer_xformer=2, n_hidden_xformer=32, embed_dim=32, n_head=2, n_seq=40,
              n_tok=TrieTokenizer(n_seq=40, **get_vocab("coati2_12_12")).n_token)
    jcfg = j2.Coati2Config(precision="highest", **kw)
    jparams = j2.init_coati2(jax.random.PRNGKey(3), jcfg)
    tcfg = t2.Coati2Config(**kw)
    module = t2.Coati2Model(tcfg)
    module.load_state_dict(coati2_state_from_coati_tpu(params_to_state(jparams), tcfg.enc_to_coati))
    tok = TrieTokenizer(n_seq=40, **get_vocab("coati2_12_12"))
    jtok = JaxTokenizer(n_seq=40, **get_vocab("coati2_12_12"))
    model = t2.COATI2(module, tcfg)
    h = np.random.default_rng(4).normal(size=(5, 32)).astype(np.float32)
    _, ref_tokens = model.hcoati_to_2d_batch(h, tok, inv_temp=20.0, k=1, return_tokens=True,
                                             keep_special=True)
    prefix = list(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))
    xcfg = tcfg.xformer_config
    eng = ContinuousDecoder(
        model._compute.xformer, xcfg, prefix, n_slots=2, stop_token=tok.stop_token,
        pad_token=tok.pad_token, inject_token=tok.unk_token, k=1, inv_temp=20.0,
        segment_len=8, inj_transform=lambda x: model._to_token(x), inj_dim=32)
    budget = 20
    rids = [eng.submit(h[i], max_new_tokens=budget) for i in range(5)]
    out = eng.run_until_done()

    jmodel = j2.COATI2(jparams, jcfg)
    jx = jcfg.xformer_config
    jeng = JaxDecoder(
        jparams.xformer, jx, prefix, n_slots=2, stop_token=jtok.stop_token,
        pad_token=jtok.pad_token, inject_token=jtok.unk_token, k=1, inv_temp=20.0,
        segment_len=8, inj_dim=32,
        inj_transform=lambda x: j2.apply_swiglu_resnet(
            jmodel.params.coati_to_token, x.astype(jx.compute_dtype), jx.mm_precision))
    jr = [jeng.submit(h[i], max_new_tokens=budget) for i in range(5)]
    jout = jeng.run_until_done()
    for i, rid in enumerate(rids):
        got = [int(x) for x in out[rid]]
        want = list(ref_tokens[i])
        if tok.stop_token in want:
            want = want[: want.index(tok.stop_token) + 1]
        assert got == want[: len(prefix) + budget], f"request {i}"
        assert got == [int(x) for x in jout[jr[i]]], f"request {i}"


@pytest.mark.parametrize("pipeline", [True, False])
def test_engine_over_two_devices_equals_one_device_and_coati_tpu_s_sharded_engine(pipeline):
    """6 requests through 4 slots over ["cpu", "cpu"] (n_rows 6: slots 0-2
    on the first device, slot 3 and two scratch rows on the second), greedy:
    token for token the one-device engine's and coati_tpu's engine's over
    make_mesh(2)."""
    from coati_tpu.parallel.mesh import make_mesh

    jparams, jcfg, module, cfg = _pair(seed=5)
    inj = _injections(6, seed=11)
    budgets = [None, 3, 9, None, 5, 14]
    outs = []
    for mesh in (None, ["cpu", "cpu"]):
        eng = _engine(module, cfg, n_slots=4, segment_len=5, pipeline=pipeline, mesh=mesh)
        rids = [eng.submit(x, max_new_tokens=b) for x, b in zip(inj, budgets)]
        out = eng.run_until_done()
        outs.append([[int(t) for t in out[r]] for r in rids])
    assert eng.n_rows % 2 == 0 and eng.n_rows == 6 and sorted(eng._free) == [0, 1, 2, 3]
    jeng = JaxDecoder(jparams, jcfg, PREFIX, n_slots=4, stop_token=STOP, pad_token=PAD,
                      inject_token=UNK, k=1, inv_temp=2.0, segment_len=5, pipeline=pipeline,
                      mesh=make_mesh(2))
    assert jeng.n_rows == eng.n_rows
    jr = [jeng.submit(x, max_new_tokens=b) for x, b in zip(inj, budgets)]
    jout = jeng.run_until_done()
    assert outs[1] == outs[0]
    assert outs[1] == [[int(t) for t in jout[r]] for r in jr]


@pytest.mark.parametrize("k", [1, 5])
def test_segments_run_no_step_once_no_row_is_live(monkeypatch, k):
    """Every decode step the engine runs has a live row, the clock moves by
    the steps run, and a segment over dead rows runs no step."""
    from coati_tpu_torch.serving import continuous

    _, _, module, cfg = _pair(seed=4)
    inj = _injections(11, seed=5)
    eng = _engine(module, cfg, k=k, seed=7, segment_len=12)
    real = continuous.decode_step_ring

    def step(*args):
        assert bool(eng.shards[0].state.live.any()), "a decode step over dead rows"
        return real(*args)

    monkeypatch.setattr(continuous, "decode_step_ring", step)
    rids = [eng.submit(x, max_new_tokens=b) for x, b in zip(inj, BUDGETS)]
    out = eng.run_until_done()
    assert sorted(out) == sorted(rids) and eng.decode_steps > 0
    assert eng.clock == eng.decode_steps % eng.w_ring
    steps, segments = eng.decode_steps, eng.segments
    eng._segment(12)
    assert (eng.decode_steps, eng.segments) == (steps, segments + 1)


def test_late_harvest_reads_the_segment_end_snapshot():
    """Pipelined, a row that finishes in segment i is harvested after
    segment i+1 ran, from host copies taken when segment i ended: the copies
    are not the engine's tensors, later segments leave them as they were,
    and the harvested row is the one decoded alone."""
    _, _, module, cfg = _pair(seed=1)
    inj = _injections(3, seed=6)
    eng = _engine(module, cfg, n_slots=4, segment_len=3, segment_len_hot=None, adaptive=False)
    short = eng.submit(inj[0], max_new_tokens=2)
    long = [eng.submit(x) for x in inj[1:]]
    eng.step()  # segment 1: the short row ends; its snapshot waits
    snap = eng._snap
    assert snap is not None and not eng.pop_results()
    assert snap.tokens.data_ptr() != eng.shards[0].state.tokens.data_ptr()
    frozen = (snap.live.clone(), snap.lpos.clone(), snap.tokens.clone())
    eng.step()  # segment 2 runs, then segment 1's snapshot is harvested
    assert all(torch.equal(a, b) for a, b in zip(frozen, (snap.live, snap.lpos, snap.tokens)))
    moved = [s for s in range(2) if int(eng.shards[0].state.lpos[s]) != int(frozen[1][s])]
    assert moved, "the long rows advanced past the snapshot"
    done = eng.pop_results()
    assert list(done) == [short]
    alone = generate_with_injection_batch(
        module, cfg, None, PREFIX, torch.as_tensor(inj[:1]), stop_token=STOP, pad_token=PAD,
        unk_token=UNK, k=1, total_len=N_SEQ)[0]
    assert done[short].tolist() == _budgeted(_trim(alone, N_SEQ), 2)
    out = eng.run_until_done()
    assert sorted(out) == sorted(long)


def test_concurrent_submission_completes_every_request_once():
    _, _, module, cfg = _pair(seed=2)
    eng = _engine(module, cfg, n_slots=4, segment_len=4)
    rids, lock = [], threading.Lock()
    inj = _injections(9, seed=8)

    def producer(rows):
        for x in rows:
            rid = eng.submit(x, max_new_tokens=6)
            with lock:
                rids.append(rid)

    threads = [threading.Thread(target=producer, args=(inj[i::3],)) for i in range(3)]
    for t in threads:
        t.start()
    for _ in range(300):
        alive = any(t.is_alive() for t in threads)
        eng.step()
        if not alive and not eng.n_pending and not eng.n_active:
            break
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    out = eng.run_until_done()
    assert sorted(out) == sorted(rids) and len(out) == 9


def test_warmup_leaves_the_engine_as_it_was():
    _, _, module, cfg = _pair(seed=3)
    inj = _injections(4, seed=9)
    a = _engine(module, cfg, n_slots=4, k=5, seed=2)
    b = _engine(module, cfg, n_slots=4, k=5, seed=2)
    b.warmup()
    assert b.clock == 0 and not b.shards[0].state.live.any() and b.n_pending == 0
    outs = []
    for eng in (a, b):
        rids = [eng.submit(x, max_new_tokens=7) for x in inj]
        out = eng.run_until_done()
        outs.append([out[r].tolist() for r in rids])
    assert outs[0] == outs[1]


def test_engine_takes_one_device_only_and_checks_its_inputs():
    """A device or a list of one gives the one-device pool; a list of two
    splits the rows (n_rows a multiple of the devices, a scratch row at
    least) over the trunks the caller placed, one a device or one for a
    device named twice, and copies none; a trunk count or a device that
    does not match the mesh is refused."""
    _, _, module, cfg = _pair()
    for mesh in ("cpu", [torch.device("cpu")]):
        eng = _engine(module, cfg, mesh=mesh)
        assert len(eng.shards) == 1 and eng.n_rows == 9
    two = _engine(module, cfg, mesh=["cpu", "cpu"])
    assert two.n_rows == 10 and [sh.lo for sh in two.shards] == [0, 5]
    assert two.shards[0].params is module and two.shards[1].params is module
    other = copy.deepcopy(module)
    listed = _engine([module, other], cfg)
    assert listed.devices == [torch.device("cpu")] * 2
    assert listed.shards[0].params is module and listed.shards[1].params is other
    with pytest.raises(ValueError, match="one trunk for each device"):
        _engine([module, other, module], cfg, mesh=["cpu", "cpu"])
    with pytest.raises(ValueError, match="one trunk for each device"):
        _engine(module, cfg, mesh=["meta"])
    eng = _engine(module, cfg)
    with pytest.raises(ValueError, match="injection"):
        eng.submit(np.zeros(31, np.float32))


def test_service_resolves_futures_and_fails_a_broken_step():
    """ContinuousService: each request's future gets its decoded row; a
    step that raises fails the futures of the requests in flight, and the
    service serves the next ones."""
    _, _, module, cfg = _pair(seed=1)
    inj = _injections(3, seed=10)
    eng = _engine(module, cfg, n_slots=2, segment_len=4)
    service = ContinuousService(eng, lambda tokens: [int(x) for x in tokens], idle_sleep=0.001)
    try:
        futs = [service.submit(x, max_new_tokens=5) for x in inj]
        rows = [f.result(timeout=30) for f in futs]
        assert all(r[:3] == PREFIX and len(r) <= 8 for r in rows)
        real_segment = eng._segment

        def broken(seg_len):
            raise RuntimeError("kernel failed")

        eng._segment = broken
        fut = service.submit(inj[0], max_new_tokens=5)
        with pytest.raises(RuntimeError, match="kernel failed"):
            fut.result(timeout=30)
        eng._segment = real_segment
        assert service.submit(inj[0], max_new_tokens=5).result(timeout=30) == rows[0]
    finally:
        service.close()
    assert not service._thread.is_alive()
