"""coati_tpu_torch's data loading against coati_tpu's on the CPU: the
small host utilities and the local half of the artifact store, the shard
readers and the bounded shuffle, COATI_dataset (the same batches, field by
field, from one shard directory and one shuffle seed; disjoint and
exhaustive partitions; the download asked for only when the shards are
missing; prefetch raising a worker's exception), and XformWorkerPool
(ordered, equal to the serial transform, at most read_ahead + workers
batches pulled ahead, with the defaults too, workers that do not share one global random stream).

The shards are built as tests/test_dataset_integration.py builds them.
The pool runs 2 workers over a few batches."""

import multiprocessing
import os
import pickle
import random

import numpy as np
import pytest

from coati_tpu.common import artifacts as jart
from coati_tpu.common import util as jutil
from coati_tpu.data import batch_pipe as jbp
from coati_tpu.data.dataset import COATI_dataset as JaxDataset
from coati_tpu.data.xform import clip_ar_xform as jax_xform
from coati_tpu.tokenizers import get_vocab as jax_get_vocab
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer

from coati_tpu_torch.common import artifacts as tart
from coati_tpu_torch.common import util as tutil
from coati_tpu_torch.data import batch_pipe as tbp
from coati_tpu_torch.data import dataset as tds
from coati_tpu_torch.data import host_workers
from coati_tpu_torch.data import load_points_fixture
from coati_tpu_torch.data.host_workers import XformWorkerPool
from coati_tpu_torch.data.xform import clip_ar_xform
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMILES = ["C", "CC", "CCO", "c1ccccc1", "CCN", "CC(=O)O", "CCCC", "CCOC"]
# every draw of clip_ar_xform decided by a probability of 0 or 1
FIXED_DRAWS = dict(p_dataset=0.0, p_formula=0.0, p_fim=0.0, p_graph=0.0, p_clip=1.0,
                   p_clip_cut=0.0, p_randsmiles=0.0)


@pytest.fixture()
def shard_dir(tmp_path):
    rng = np.random.default_rng(0)
    shard_root = tmp_path / tds.S3_PATH
    os.makedirs(shard_root)
    rows = []
    for i in range(400):
        smi = SMILES[i % len(SMILES)] + "C" * (i % 3)
        n = 3 + i % 5
        rows.append({"smiles": smi, "source_collection": "geom_drugs",
                     "atoms": rng.integers(1, 9, size=(n,)).astype(np.float64),
                     "coords": rng.normal(size=(n, 3))})
    for s in range(4):
        with open(shard_root / f"{s}.pkl", "wb") as f:
            pickle.dump(rows[s * 100 : (s + 1) * 100], f)
    return str(tmp_path)


def _assert_batches_equal(mine, ref):
    assert len(mine) == len(ref) > 0
    for b, r in zip(mine, ref):
        assert b.keys() == r.keys()
        for key in r:
            assert np.asarray(b[key]).dtype == np.asarray(r[key]).dtype, key
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(r[key]), err_msg=key)


# ------------------------------------------------------------ small helpers


def test_util_helpers_equal_coati_tpu_s(tmp_path, monkeypatch):
    seq = list(range(11))
    assert list(tutil.batch_indexable(seq, 4)) == list(jutil.batch_indexable(seq, 4))
    assert list(tutil.batch_indexable("abcdefg", 3)) == list(jutil.batch_indexable("abcdefg", 3))
    assert tutil.dir_or_file_exists(str(tmp_path)) and not tutil.dir_or_file_exists(
        str(tmp_path / "no"))
    (tmp_path / "tree" / "sub").mkdir(parents=True)
    tutil.rmdir(str(tmp_path / "tree"))
    assert not (tmp_path / "tree").exists()
    tutil.rmdir(str(tmp_path / "tree"))  # a missing tree is printed, not raised
    monkeypatch.setenv("COATI_TPU_ASSUME_YES", "1")
    assert tutil.query_yes_no("go?") is jutil.query_yes_no("go?") is True


def test_artifacts_local_half_equals_coati_tpu_s(tmp_path, monkeypatch):
    monkeypatch.setenv("COATI_TPU_CACHE_DIR", str(tmp_path / "cache"))
    assert tart.cache_dir() == jart.cache_dir() == str(tmp_path / "cache")
    uri = "s3://terray-public/models/doc.pkl"
    assert tart.local_cache_path(uri) == jart.local_cache_path(uri)
    path = tmp_path / "blob.bin"
    path.write_bytes(b"\x00coati")
    for name in (str(path), "file://" + str(path)):
        with tart.cache_read(name) as f:
            assert f.read() == b"\x00coati"
    assert tart.HAS_BOTO3 == jart.HAS_BOTO3
    if not tart.HAS_BOTO3:
        with pytest.raises(ImportError, match="boto3"):
            with tart.cache_read(uri):
                pass
        with pytest.raises(ImportError, match="boto3"):
            tart.copy_bucket_dir_from_s3("datasets/", str(tmp_path))


def test_unstack_pickles_and_shuffle_buffer_equal_coati_tpu_s(shard_dir):
    paths = tds.COATI_dataset(shard_dir).shard_paths()
    assert [len(r) for r in tbp.unstack_pickles(paths)] == [100] * 4
    items = list(range(250))
    for buffer_size in (1, 16, 64, 1000):
        mine = list(tbp.shuffle_buffer(iter(items), buffer_size, np.random.default_rng(5)))
        ref = list(jbp.shuffle_buffer(iter(items), buffer_size, np.random.default_rng(5)))
        assert mine == ref and sorted(mine) == items


# ----------------------------------------------------------------- dataset


@pytest.mark.parametrize("partition,batch_size", [("train", 16), ("valid", 4), ("test", 4)])
def test_data_pipe_gives_coati_tpu_s_batches(shard_dir, partition, batch_size):
    """One shard directory, one shuffle seed, the transform's draws fixed
    (its probabilities 0 or 1, and its generator seeded alike for the order
    of the [SET] and [SMILES] blocks): the same batches, field by field
    (smiles, the hash, atoms padded to their bucket, coordinates, tokens,
    targets), as coati_tpu's."""
    tok = TrieTokenizer(n_seq=48, **get_vocab("mar"))
    jtok = JaxTokenizer(n_seq=48, **jax_get_vocab("mar"))
    draws = dict(FIXED_DRAWS, p_dataset=1.0)
    rng, jrng = random.Random(7), random.Random(7)
    kw = dict(batch_size=batch_size, partition=partition, shuffle_seed=3, row_buffer=64)
    mine = list(tds.COATI_dataset(shard_dir, test_frac=0.1, valid_frac=0.1).get_data_pipe(
        xform_routine=lambda b: clip_ar_xform(b, tok, rng=rng, **draws), **kw))
    ref = list(JaxDataset(shard_dir, test_frac=0.1, valid_frac=0.1).get_data_pipe(
        xform_routine=lambda b: jax_xform(b, jtok, rng=jrng, **draws), **kw))
    _assert_batches_equal(mine, ref)
    assert all(b["atoms"].shape[1] in tbp.ATOM_BUCKETS for b in mine)
    assert "tokens" in mine[0] and "y_next" in mine[0]


def test_partitions_are_disjoint_and_exhaustive(shard_dir):
    """Every row lands in exactly one of train / valid / test, the one its
    md5 hash gives, and in the same one as in coati_tpu's pipe."""
    ds = tds.COATI_dataset(shard_dir, test_frac=0.1, valid_frac=0.1)
    jds = JaxDataset(shard_dir, test_frac=0.1, valid_frac=0.1)
    seen, rows = {}, 0
    for part in ("train", "valid", "test"):
        got = [str(s) for b in ds.get_data_pipe(batch_size=1, partition=part, shuffle_seed=1,
                                                row_buffer=16) for s in b["smiles"]]
        want = [str(s) for b in jds.get_data_pipe(batch_size=1, partition=part, shuffle_seed=1,
                                                  row_buffer=16) for s in b["smiles"]]
        assert got == want
        rows += len(got)
        for smi in got:
            assert seen.get(smi, part) == part, f"{smi} in two partitions"
            seen[smi] = part
    assert rows == 400 and set(seen.values()) == {"train", "valid", "test"}
    for smi, part in seen.items():
        mod = tbp.get_mod_from_str(smi) % 100
        assert part == ("test" if mod < 10 else "valid" if mod < 20 else "train")
    with pytest.raises(ValueError, match="test_frac"):
        tds.COATI_dataset(shard_dir, test_frac=0.3, valid_frac=0.3)


def test_ensure_cache_asks_only_when_the_shards_are_missing(shard_dir, tmp_path, monkeypatch):
    def refuse(question, default=None):
        raise AssertionError("asked with the shards present")

    monkeypatch.setattr(tds, "query_yes_no", refuse)
    tds.COATI_dataset(shard_dir).ensure_cache()
    empty = tds.COATI_dataset(str(tmp_path / "empty"))
    monkeypatch.setattr(tds, "query_yes_no", lambda question, default=None: False)
    with pytest.raises(FileNotFoundError, match="declined"):
        empty.ensure_cache()
    if not tart.HAS_BOTO3:  # accepted: the mirror needs boto3, and nothing is fetched
        monkeypatch.setattr(tds, "query_yes_no", lambda question, default=None: True)
        with pytest.raises(ImportError, match="boto3"):
            list(empty.get_data_pipe())


def test_prefetch_keeps_order_and_raises_the_worker_s_exception():
    assert list(tds.prefetch(iter(range(10)), depth=2)) == list(range(10))

    def bad_iter():
        yield 1
        yield 2
        raise RuntimeError("corrupt shard")

    it = tds.prefetch(bad_iter(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="corrupt shard"):
        next(it)


# -------------------------------------------------------------- worker pool


def _raw_batch(i, smiles):
    return {"smiles": np.asarray(smiles, dtype=object),
            "source_collection": np.asarray(["geom_drugs"] * len(smiles), dtype=object),
            "atoms": np.ones((len(smiles), 4)) * 6, "coords": np.zeros((len(smiles), 4, 3)),
            "index": i}


class _Counting:
    """An iterator of raw batches that counts how many were pulled."""

    def __init__(self, n, smiles):
        self.n, self.smiles, self.pulled = n, smiles, 0

    def __iter__(self):
        for i in range(self.n):
            self.pulled += 1
            yield _raw_batch(i, self.smiles)


def test_pool_is_ordered_and_equals_the_serial_transform():
    tok = TrieTokenizer(n_seq=48, **get_vocab("mar"))
    smiles = ["C", "CCO", "c1ccccc1", "CC(=O)O", "OC(=O)c1ccccc1"]
    with XformWorkerPool("mar", 48, xform_kwargs=FIXED_DRAWS, n_workers=2) as pool:
        out = list(pool.map(_raw_batch(i, smiles) for i in range(6)))
    serial = [clip_ar_xform(_raw_batch(i, smiles), tok, **FIXED_DRAWS) for i in range(6)]
    assert [b["index"] for b in out] == list(range(6))
    _assert_batches_equal(out, serial)


@pytest.mark.parametrize("read_ahead", [1, 3])
def test_pool_pulls_at_most_read_ahead_batches_ahead(read_ahead):
    """While the consumer holds batch k, at most k + 1 + read_ahead +
    workers raw batches have been pulled: never more than read_ahead
    batches queued behind the two busy workers, and the pool does reach
    that many."""
    source = _Counting(10, ["CCO", "c1ccccc1"])
    with XformWorkerPool("mar", 48, xform_kwargs=FIXED_DRAWS, n_workers=2,
                         read_ahead=read_ahead) as pool:
        for k, batch in enumerate(pool.map(source)):
            assert batch["index"] == k
            assert source.pulled - (k + 1) <= read_ahead + 2
        assert pool.peak_in_flight == read_ahead + 2
    assert source.pulled == 10
    with pytest.raises(ValueError, match="read_ahead"):
        XformWorkerPool("mar", 48, read_ahead=0)


def test_pool_with_the_defaults_keeps_every_worker_busy(monkeypatch):
    """The defaults (cores - 2 workers, read_ahead 4) on a 4-core host: 2
    workers, and up to 4 + 2 batches in flight, so that neither worker
    waits for the next batch while read_ahead are queued."""
    monkeypatch.setattr(host_workers.mp, "cpu_count", lambda: 4)
    source = _Counting(10, ["CCO", "c1ccccc1"])
    with XformWorkerPool("mar", 48, xform_kwargs=FIXED_DRAWS) as pool:
        assert (pool.n_workers, pool.read_ahead) == (2, 4)
        for k, batch in enumerate(pool.map(source)):
            assert batch["index"] == k
            assert source.pulled - (k + 1) <= 4 + 2
        assert pool.peak_in_flight == 4 + 2
    assert source.pulled == 10


def _first_draws(queue, smiles, kwargs):
    """What a pool worker does: its initializer, then one batch; reports
    its pid, the first draws of the global random and numpy modules after
    the initializer, and the batch's permuted targets and noised
    coordinates."""
    host_workers._worker_init("mar", 250, kwargs, 0)
    r, n = random.random(), float(np.random.random())
    out = host_workers._worker_apply(_raw_batch(0, smiles))
    queue.put((os.getpid(), r, n, [tuple(row) for row in out["raw_tokens"]], out["coords"]))


def test_pool_workers_draw_different_global_random_streams():
    """permute_smiles draws from the global random module, and coordinate
    noise from numpy's. Two workers forked from one parent state, each
    through the pool's initializer: each has seeded both modules from
    seed + pid, and they permute and noise the same batch otherwise.
    (Python reseeds `random` from the OS at a fork, unreproducibly; numpy
    keeps the parent's state, so without the seed the noise would repeat.)
    The processes are started here, so that both surely run."""
    smiles, _, _ = load_points_fixture()
    batch = [max(smiles[:64], key=len)] * 4
    kwargs = dict(FIXED_DRAWS, p_randsmiles=1.0, coord_noise=True)
    ctx = multiprocessing.get_context("fork")
    queue = ctx.Queue()
    random.seed(0)
    np.random.seed(0)
    procs = [ctx.Process(target=_first_draws, args=(queue, batch, kwargs)) for _ in range(2)]
    for p in procs:
        p.start()
    first, second = (queue.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    for pid, r, n, targets, _ in (first, second):
        assert r == random.Random(pid).random()  # seed 0 + pid
        assert n == np.random.RandomState(pid).random_sample()
        assert len(set(targets)) == 4  # each row permuted anew
    assert first[3] != second[3]
    assert not np.array_equal(first[4], second[4]) and first[2] != second[2]


def test_pool_raises_a_worker_s_exception_at_its_batch():
    bad = _raw_batch(1, ["CCO"])
    del bad["smiles"]
    with XformWorkerPool("mar", 48, xform_kwargs=FIXED_DRAWS, n_workers=2) as pool:
        it = pool.map([_raw_batch(0, ["CCO"]), bad])
        assert next(it)["index"] == 0
        with pytest.raises(KeyError, match="smiles"):
            next(it)
