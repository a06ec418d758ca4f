"""Continuous-batching decode engine (slot recycling).

Counterpart of coati_tpu/serving/continuous.py. The sampler
(models/sampler.py) holds every co-batched row until all rows stop, so
under the micro-batcher one long molecule makes every co-batched short
request pay its length. This engine keeps a fixed pool of rows on the card
and recycles a row's slot as soon as its request ends:

  * `n_slots` rows (plus one scratch row, never live) with a ring-buffer
    KV cache. Rows sit at different logical depths, but every row writes
    its K/V at the same ring slot each step (a global clock), so the cache
    update is an in-place store at one index; per-row state enters through
    the rotary tables gathered at each row's logical position and the
    attention mask from ring-age arithmetic (models/transformer.py
    decode_step_ring, ops/attention.py decode_attention_ring);
  * decode runs in segments of `segment_len` tokens, ending early once no
    row is live;
  * between segments the host harvests finished rows (their slots free at
    once) and admits queued requests into free slots: each admission group
    is prefilled (through K2) and its prefix K/V placed at the ring slots
    of the preceding clocks. Groups are sized to powers of two, as in
    coati_tpu, where that bounded its compiled programs. The ring is
    total_len + one segment wide, rounded to 16: a row's oldest key ages
    past overwrite only once the row has ended.

The early exit reads any(live) on the host before every decode step, one
wait for the card a step: a decode step's host work outlasts its card work,
so the wait costs little, and no step runs once every row is dead.

Pipelining: with `pipeline`, each segment ends with a snapshot of the
rows' live flags, positions and tokens, copied into fresh host memory
(pinned, non-blocking, with a CUDA event that the harvest waits on), and
the harvest of a segment runs after the next segment has been dispatched.
The copy is what makes the late harvest exact: the engine updates its
tensors in place, and a harvest reading them one boundary late would read
the next segment's state.

Several devices (`mesh`, a list of devices; one process, as
parallel/inference.py): coati_tpu shards the slot pool over a mesh's first
axis. Here the pool has n_rows = ceil((n_slots + 1) / n_dev) * n_dev rows,
and each device holds n_rows / n_dev consecutive ones: its own ring KV
cache, the trunk the caller placed on it (one trunk a device, or one trunk
for every device when all are its own) and its own generator; the engine
copies no weights. Admission picks slots as on one device and prefills
each device's share of a group on that device; the ring clock is the
engine's, shared by every device. Each decode step launches every device's
step from its own thread (on its device) and reads that device's any(live);
the segment goes on while any device has a live row. A harvest reads every
device's rows from one host snapshot.

Sampling draws from the engine's own torch.Generator (seeded by `seed`; a
device's is seeded seed + its index), so its random tokens differ from
coati_tpu's; greedy (k = 1) decodes agree token for token. Top-k is exact
(coati_tpu's engine samples with its approximate top-k).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from coati_tpu_torch.models.transformer import (
    KVCache,
    SmilesTransformer,
    TransformerConfig,
    decode_step_ring,
    make_empty_cache,
    prefill,
)
from coati_tpu_torch.ops.layers import cast_floats, linear
from coati_tpu_torch.ops.sampling import sample_top_k
from coati_tpu_torch.parallel.mesh import on_device


def mesh_devices(mesh, default: torch.device) -> List[torch.device]:
    """The devices a `mesh` argument names: None -> [default]; a device (a
    torch.device or a string) -> [it]; a sequence of devices -> them."""
    if mesh is None:
        return [default]
    if isinstance(mesh, (str, torch.device)):
        return [torch.device(mesh)]
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("name at least one device")
    return devices


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b name one device ("cuda" names the current one)."""
    def index(d):
        if d.type == "cuda" and d.index is None:
            return torch.cuda.current_device()
        return d.index

    return a.type == b.type and index(a) == index(b)


@dataclass
class PoolState:
    """The slot pool on the card. Rows n_slots..n_rows-1 are scratch rows,
    never live. `lpos` is each row's logical position (the index of `cur`
    in its own sequence). The ring cursor is the engine's host int
    `clock`: slot `clock` is where the next step writes every row's K/V."""

    tokens: torch.Tensor  # (S+1, W) int64
    lpos: torch.Tensor  # (S+1,) int64
    cur: torch.Tensor  # (S+1,) int64, the current input token
    live: torch.Tensor  # (S+1,) bool
    row_max: torch.Tensor  # (S+1,) int64, each request's length budget


@dataclass
class _Shard:
    """One device's consecutive rows [lo, lo + n) of the pool: the weights
    it reads, its state, ring cache and generator."""

    device: torch.device
    params: SmilesTransformer
    lo: int
    n: int
    state: PoolState
    cache: KVCache
    generator: torch.Generator
    prefix_tokens: torch.Tensor


@dataclass
class _Snapshot:
    """Host copies of a segment's live, lpos and tokens over every device's
    rows, the events that mark the copies done (none on the CPU), and the
    slots occupied when it was taken."""

    live: torch.Tensor
    lpos: torch.Tensor
    tokens: torch.Tensor
    events: List[torch.cuda.Event]
    slots: set


@dataclass
class _Request:
    rid: int
    injection: np.ndarray
    max_len: int = 0  # total row budget including the prefix
    tokens: Optional[np.ndarray] = None  # filled at harvest


class ContinuousDecoder:
    """Embedding-conditioned generation with slot recycling: submit
    injection vectors, collect token rows as they finish.

    Requests share a token prefix (e.g. [CLIP][UNK][SMILES]) with a
    per-request injection over `inject_token`. Sampling (k, inv_temp) is
    the same for every request of an engine. The engine runs on the device
    of `params`, or on the devices of `mesh`."""

    def __init__(
        self,
        params: Union[SmilesTransformer, Sequence[SmilesTransformer]],
        cfg: TransformerConfig,
        prefix: List[int],
        *,
        n_slots: int = 64,
        total_len: Optional[int] = None,
        stop_token: int,
        pad_token: int = 0,
        inject_token: Optional[int] = None,
        k: int = 100,
        inv_temp: float = 2.0,
        segment_len: int = 48,
        segment_len_hot: Optional[int] = 16,
        pipeline: bool = True,
        adaptive: bool = True,
        seed: int = 0,
        inj_transform=None,
        inj_dim: Optional[int] = None,
        mesh=None,
    ):
        """segment_len_hot: a shorter segment run while requests wait for a
        slot (a waiting request gets its slot at the next boundary); None
        disables it.

        pipeline: dispatch segment i+1 before harvesting segment i (a
        finished row returns one boundary later).

        adaptive: with pipeline, harvest before dispatching when most active
        rows finish each segment and requests are queued (see step()).

        inj_transform: optional (g, D_in) -> (g, D) map applied to each
        admission group's injections (e.g. COATI's clip_to_special_token),
        so callers submit raw embeddings; inj_dim: the width they are
        submitted at (defaults to the model width). Over several devices it
        is called with each device's share, on that device.

        params: the trunk, or one trunk a device of `mesh` (in its order),
        each on its device. One trunk serves every device of a mesh that
        names only its device.

        mesh: None (the devices of `params`), a device, or a list of
        devices over which the slot pool is split (see the module
        docstring)."""
        self.cfg = cfg
        self.prefix = list(prefix)
        self.n_slots = n_slots
        self.w = total_len or cfg.n_seq
        self.stop_token = stop_token
        self.pad_token = pad_token
        self.inject_token = inject_token
        self.k = k
        self.inv_temp = inv_temp
        self.segment_len = segment_len
        self.segment_len_hot = segment_len_hot
        self.pipeline = pipeline
        self.adaptive = adaptive
        self.inj_transform = inj_transform
        self.inj_dim = inj_dim
        if not 1 <= len(self.prefix) < self.w:
            raise ValueError(f"prefix of {len(self.prefix)} tokens does not fit total_len {self.w}")
        if self.w > cfg.n_seq:
            raise ValueError(f"total_len {self.w} exceeds the model's rotary range "
                             f"(n_seq {cfg.n_seq})")
        # ring width: a row's oldest key reaches overwrite age only after the
        # row's last step; one segment (the longest) of slack, 16-aligned
        slack = max(segment_len, segment_len_hot or 0)
        self.w_ring = ((self.w + slack + 15) // 16) * 16
        trunks = list(params) if isinstance(params, (list, tuple)) else [params]
        homes = [t.lm_head.weight.device for t in trunks]
        self.devices = homes if mesh is None else mesh_devices(mesh, homes[0])
        n_dev = len(self.devices)
        if len(trunks) == 1:
            trunks, homes = trunks * n_dev, homes * n_dev
        if len(trunks) != n_dev or any(not _same_device(h, d)
                                       for h, d in zip(homes, self.devices)):
            raise ValueError(f"pass one trunk for each device of {self.devices}, on it; "
                             f"the trunks are on {homes}")
        # at least one scratch row (never live), the rows split evenly
        self.n_rows = -(-(n_slots + 1) // n_dev) * n_dev
        per = self.n_rows // n_dev
        self.shards: List[_Shard] = []
        for i, (dev, trunk) in enumerate(zip(self.devices, trunks)):
            self.shards.append(_Shard(
                device=dev, params=cast_floats(trunk, cfg.compute_dtype), lo=i * per,
                n=per, state=PoolState(
                    tokens=torch.zeros((per, self.w), dtype=torch.long, device=dev),
                    lpos=torch.zeros((per,), dtype=torch.long, device=dev),
                    cur=torch.zeros((per,), dtype=torch.long, device=dev),
                    live=torch.zeros((per,), dtype=torch.bool, device=dev),
                    row_max=torch.full((per,), self.w, dtype=torch.long, device=dev)),
                cache=make_empty_cache(cfg, per, width=self.w_ring, device=dev),
                generator=torch.Generator(device=dev).manual_seed(seed + i),
                prefix_tokens=torch.as_tensor(self.prefix, dtype=torch.long, device=dev)))
        self.device = self.devices[0]
        self.clock = 0
        self._pool: Optional[ThreadPoolExecutor] = None  # a thread a device, made at first use
        self._free: List[int] = list(range(n_slots))
        self._slot_req: Dict[int, _Request] = {}
        self._pending: List[_Request] = []
        self._done: Dict[int, _Request] = {}
        self._next_rid = 0
        self._lock = threading.Lock()  # guards _pending, _done, _next_rid
        self._snap: Optional[_Snapshot] = None  # the last segment's, not yet harvested
        # EMA of the share of active slots that finish per harvest; steers
        # the harvest order in step(). 1.0 at first: sequential harvesting
        # is the safe default, and one low-rate harvest turns on pipelining.
        self._finish_rate = 1.0
        self.segments = 0  # segments run, for reports
        self.decode_steps = 0  # decode steps run, for reports

    # ----------------------------------------------------------- device

    def _each(self, fn, shards=None) -> list:
        """fn(shard) for each shard (every one by default), each on its
        device and, over several devices, in its own thread; the results in
        shard order."""
        shards = self.shards if shards is None else shards

        def run(sh):
            with on_device(sh.device):
                return fn(sh)

        if len(shards) == 1:
            return [run(sh) for sh in shards]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(len(self.shards), thread_name_prefix="engine-device")
        return [f.result() for f in [self._pool.submit(run, sh) for sh in shards]]

    def close(self) -> None:
        """End the threads that launch the devices' work (a later step makes
        them again)."""
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _decode(self, sh: _Shard, ring_pos: int) -> bool:
        """One decode step of a device's rows; whether a row is live after."""
        st, w = sh.state, self.w
        rows = torch.arange(sh.n, device=sh.device)
        logits, sh.cache = decode_step_ring(sh.params, self.cfg, st.cur, st.lpos, ring_pos,
                                            sh.cache)
        nxt = sample_top_k(sh.generator, logits, self.k, self.inv_temp)
        can = st.live & (st.lpos + 1 < torch.clamp(st.row_max, max=w))
        nxt = torch.where(can, nxt, self.pad_token)
        wpos = torch.clamp(st.lpos + 1, max=w - 1)
        st.tokens[rows, wpos] = torch.where(can, nxt, st.tokens[rows, wpos])
        st.live = can & (nxt != self.stop_token)
        st.lpos = torch.where(can, st.lpos + 1, st.lpos)
        st.cur = torch.where(can, nxt, st.cur)
        return bool(st.live.any())

    @torch.no_grad()
    def _segment(self, seg_len: int) -> None:
        """Up to seg_len decode steps over the pool, ending early once no
        row of any device is live."""
        clock0 = self.clock
        ran = 0
        live = self._each(lambda sh: bool(sh.state.live.any()))
        while ran < seg_len and any(live):
            ring_pos = (clock0 + ran) % self.w_ring
            live = self._each(lambda sh: self._decode(sh, ring_pos))
            ran += 1
        self.clock = (clock0 + ran) % self.w_ring
        self.segments += 1
        self.decode_steps += ran

    @torch.no_grad()
    def _admit(self, slots: List[int], inj: torch.Tensor, row_max: torch.Tensor) -> None:
        """Prefill len(slots) new rows on the common prefix with per-row
        injection, sample each row's first token, and place the rows and
        their prefix K/V in the pool: each device its own rows."""
        parts = []
        for sh in self.shards:
            mine = [i for i, s in enumerate(slots) if sh.lo <= s < sh.lo + sh.n]
            if mine:
                parts.append((sh, [slots[i] - sh.lo for i in mine], mine))
        by_shard = {id(sh): (local, mine) for sh, local, mine in parts}

        def admit(sh):
            local, mine = by_shard[id(sh)]
            pick = torch.as_tensor(mine, dtype=torch.long, device=inj.device)
            self._admit_rows(sh, local, inj[pick].to(sh.device), row_max[pick].to(sh.device))

        self._each(admit, [sh for sh, _, _ in parts])

    def _admit_rows(self, sh: _Shard, rows: List[int], inj: torch.Tensor,
                    row_max: torch.Tensor) -> None:
        g, p = len(rows), len(self.prefix)
        st, dev = sh.state, sh.device
        if self.inj_transform is not None:
            inj = self.inj_transform(inj)
        ptoks = sh.prefix_tokens[None, :].expand(g, p)
        cache = make_empty_cache(self.cfg, g, width=max(p, 8), device=dev)
        hidden, cache = prefill(
            sh.params, self.cfg, ptoks,
            injection=inj if self.inject_token is not None else None,
            inject_token=self.inject_token,
            cache=cache,
        )
        last = linear(hidden[:, -1], sh.params.lm_head.weight)
        first = sample_top_k(sh.generator, last, self.k, self.inv_temp)
        idx = torch.as_tensor(rows, dtype=torch.long, device=dev)
        tokens = torch.zeros((g, self.w), dtype=torch.long, device=dev)
        tokens[:, :p] = ptoks
        tokens[:, p] = first
        st.tokens[idx] = tokens
        st.lpos[idx] = p
        st.cur[idx] = first
        st.live[idx] = (first != self.stop_token) & (row_max > p + 1)
        st.row_max[idx] = row_max
        # the prefix K/V at the ring slots of the p clocks before the next
        # step: logical position j lands at age p - j
        cols = torch.remainder(self.clock - p + torch.arange(p, device=dev), self.w_ring)
        sh.cache.data[:, :, idx[:, None], cols[None, :]] = \
            cache.data[:, :, :, :p].to(sh.cache.data.dtype)
        if sh.cache.scale is not None:
            sh.cache.scale[:, :, idx[:, None], cols[None, :]] = \
                cache.scale[:, :, :, :p].to(sh.cache.scale.dtype)

    # ------------------------------------------------------------- host

    def submit(self, injection: np.ndarray, max_new_tokens: Optional[int] = None) -> int:
        """Queue one request; returns its id. Thread-safe: any thread may
        submit while another drives step() / run_until_done().
        max_new_tokens: the request's decode budget (the row retires at it
        even without [STOP]); at least 1, at most total_len - prefix."""
        cap = self.w - len(self.prefix)
        # admission always realizes the first sampled token, so the smallest
        # budget honoured is 1
        budget = cap if max_new_tokens is None else max(1, min(int(max_new_tokens), cap))
        injection = np.asarray(injection, np.float32)
        width = self.inj_dim or self.cfg.n_embd
        if injection.shape != (width,):
            raise ValueError(f"injection must be ({width},), got {injection.shape}")
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._pending.append(
                _Request(rid=rid, injection=injection, max_len=len(self.prefix) + budget))
        return rid

    def _admit_pending(self) -> None:
        # drain the queue into free slots in power-of-two groups: 13 pending
        # over 13 free slots admit as 8 + 4 + 1 in one tick
        while True:
            with self._lock:
                n = min(len(self._pending), len(self._free))
                if n == 0:
                    return
                g = 1 << (n.bit_length() - 1)
                batch = [self._pending.pop(0) for _ in range(g)]
            slots = [self._free.pop(0) for _ in range(g)]
            for r, s in zip(batch, slots):
                self._slot_req[s] = r
            inj = torch.as_tensor(np.stack([r.injection for r in batch]), device=self.device)
            row_max = torch.as_tensor([r.max_len for r in batch], dtype=torch.long,
                                      device=self.device)
            self._admit(slots, inj.to(self.cfg.compute_dtype), row_max)

    def _snapshot(self) -> _Snapshot:
        """Copies of every device's live, lpos and tokens as this segment
        left them, in one host tensor each: from a card, pinned and
        non-blocking, with an event on the device's stream."""
        on_card = any(sh.device.type == "cuda" for sh in self.shards)
        first = self.shards[0].state
        copies = [torch.empty((self.n_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                              pin_memory=on_card)
                  for x in (first.live, first.lpos, first.tokens)]
        events = []
        for sh in self.shards:
            st = sh.state
            for host, x in zip(copies, (st.live, st.lpos, st.tokens)):
                host[sh.lo:sh.lo + sh.n].copy_(x, non_blocking=sh.device.type == "cuda")
            if sh.device.type == "cuda":
                with on_device(sh.device):
                    event = torch.cuda.Event()
                    event.record()
                events.append(event)
        return _Snapshot(*copies, events=events, slots=set(self._slot_req))

    def _harvest(self, snap: Optional[_Snapshot] = None) -> None:
        """Return the rows finished in `snap` (or, without one, in the
        current state) and free their slots. A row dead in a snapshot is
        dead in every later state and its tokens are frozen, so harvesting
        it one boundary late is exact; slots admitted after the snapshot
        are left to a later harvest."""
        if snap is None:
            if not self._slot_req:
                return
            snap = self._snapshot()
        for event in snap.events:
            event.synchronize()
        live, pos, tokens = snap.live.numpy(), snap.lpos.numpy(), snap.tokens.numpy()
        mine = [s for s in self._slot_req if s in snap.slots]
        finished = [s for s in mine if not live[s]]
        if mine:
            self._finish_rate = 0.5 * self._finish_rate + 0.5 * len(finished) / len(mine)
        if not finished:
            return
        with self._lock:
            for s in finished:
                r = self._slot_req.pop(s)
                r.tokens = tokens[s, : pos[s] + 1].copy()
                self._done[r.rid] = r
                self._free.append(s)

    def warmup(self, group_sizes=None) -> None:
        """Build the kernels and run each admission size (the powers of two
        up to n_slots) and each segment length once on every device, on
        copies of the state and the cache: the engine's requests, state and
        random streams are left as they were."""
        if group_sizes is None:
            group_sizes = [1 << i for i in range(self.n_slots.bit_length())]
        d_in = self.inj_dim or self.cfg.n_embd
        saved = [(sh.state, sh.cache, sh.generator.get_state()) for sh in self.shards]
        counters = (self.clock, self.segments, self.decode_steps)
        try:
            for g in group_sizes:
                for sh, (state, cache, _) in zip(self.shards, saved):
                    sh.state = PoolState(*(x.clone() for x in vars(state).values()))
                    sh.cache = KVCache(*(None if x is None else x.clone()
                                         for x in vars(cache).values()))
                inj = torch.zeros((g, d_in), dtype=self.cfg.compute_dtype, device=self.device)
                row_max = torch.full((g,), self.w, dtype=torch.long, device=self.device)
                for sh in self.shards:  # each device's first row, g times
                    self._admit([sh.lo] * g, inj, row_max)
            seg_lens = {self.segment_len, self.segment_len_hot or self.segment_len}
            for seg in seg_lens:
                for sh in self.shards:
                    sh.state.live[0] = True
                self._segment(seg)
            for sh in self.shards:
                if sh.device.type == "cuda":
                    torch.cuda.synchronize(sh.device)
        finally:
            for sh, (state, cache, gen_state) in zip(self.shards, saved):
                sh.state, sh.cache = state, cache
                sh.generator.set_state(gen_state)
            self.clock, self.segments, self.decode_steps = counters

    def step(self) -> None:
        """One engine tick: admit, run one decode segment, harvest.
        Pipelined, the harvest reads the previous segment's snapshot after
        this segment ran. The segment is `segment_len_hot` long while
        requests wait for a slot, else `segment_len`.

        Adaptive harvest order: a late harvest idles a finished row's slot
        for a whole extra segment. When most active rows finish each segment
        and requests wait for slots, that idle time outweighs what the
        pipeline saves, so the snapshot is harvested before dispatching and
        the freed slots are filled this tick."""
        self._admit_pending()
        with self._lock:
            queued = bool(self._pending)
        if self.adaptive and self._snap is not None and queued and self._finish_rate > 0.25:
            snap, self._snap = self._snap, None
            self._harvest(snap)
            self._admit_pending()  # reuse the freed slots this segment
        dispatched = False
        if self._slot_req:
            with self._lock:
                hot = bool(self._pending) and bool(self.segment_len_hot)
            self._segment(self.segment_len_hot if hot else self.segment_len)
            dispatched = True
        harvested_snap = False
        if self._snap is not None:
            snap, self._snap = self._snap, None
            self._harvest(snap)
            harvested_snap = True
        if dispatched and self.pipeline:
            self._snap = self._snapshot()
        elif not (harvested_snap and not dispatched):
            # with no dispatch this tick the state is the snapshot just
            # harvested: reading it again would find nothing new
            self._harvest()

    def run_until_done(self, max_segments: int = 10_000) -> Dict[int, np.ndarray]:
        """Drain everything queued or in flight; returns {rid: tokens}."""
        n = 0
        while (self._pending or self._slot_req or self._snap is not None) and n < max_segments:
            self.step()
            n += 1
        return self.results()

    def abort(self) -> List[int]:
        """Drop every queued and in-flight request (after a failed step);
        returns their ids. The pool's rows are marked dead and their slots
        freed."""
        with self._lock:
            rids = [r.rid for r in self._pending] + [r.rid for r in self._slot_req.values()]
            self._pending.clear()
            self._free.extend(self._slot_req)
            self._slot_req.clear()
        self._snap = None
        for sh in self.shards:
            sh.state.live.zero_()
        return rids

    def results(self) -> Dict[int, np.ndarray]:
        return {rid: r.tokens for rid, r in self._done.items()}

    def pop_results(self) -> Dict[int, np.ndarray]:
        """Drain completed requests (each returned exactly once)."""
        with self._lock:
            out = {rid: r.tokens for rid, r in self._done.items()}
            self._done.clear()
        return out

    @property
    def n_active(self) -> int:
        return len(self._slot_req)

    @property
    def n_pending(self) -> int:
        with self._lock:
            return len(self._pending)


class ContinuousService:
    """MicroBatcher-compatible front of a ContinuousDecoder: submit()
    returns a Future, a daemon thread ticks the engine whenever work
    is queued or in flight, and each finished row resolves its future at
    the next segment boundary. `decode_fn(tokens) -> result` maps a
    finished token row (prefix included, stop inclusive) to the caller's
    payload. A failed step fails the futures of every request then queued
    or in flight, and the service goes on with later ones."""

    def __init__(self, engine: ContinuousDecoder, decode_fn, idle_sleep: float = 0.005,
                 name: str = "continuous"):
        self._engine = engine
        self._decode_fn = decode_fn
        self._idle_sleep = idle_sleep
        self._futures: Dict[int, Future] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    @property
    def engine(self) -> ContinuousDecoder:
        return self._engine

    def submit(self, inj_row, max_new_tokens: Optional[int] = None) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            rid = self._engine.submit(inj_row, max_new_tokens)
            self._futures[rid] = fut
        return fut

    def __call__(self, inj_row):
        return self.submit(inj_row).result()

    def _run(self) -> None:
        eng = self._engine
        while not self._closed:
            if not (eng.n_pending or eng.n_active):
                time.sleep(self._idle_sleep)
                continue
            try:
                eng.step()
            except Exception as ex:  # noqa: BLE001 - the requests' callers get it
                with self._lock:
                    futs = [self._futures.pop(rid) for rid in eng.abort()
                            if rid in self._futures]
                for f in futs:
                    f.set_exception(ex)
                continue
            for rid, tokens in eng.pop_results().items():
                with self._lock:
                    fut = self._futures.pop(rid, None)
                if fut is None:
                    continue
                try:
                    fut.set_result(self._decode_fn(tokens))
                except Exception as ex:  # noqa: BLE001 - the caller gets it
                    fut.set_exception(ex)

    def close(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._closed = True
        self._thread.join(timeout)
        self._engine.close()
        with self._lock:
            futs, self._futures = self._futures, {}
        for f in futs.values():
            if not f.done():
                f.set_exception(RuntimeError("service is closed"))
