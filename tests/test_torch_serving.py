"""coati_tpu_torch's serving layer on the CPU: MicroBatcher (batching,
max_batch, a failing batch), and the HTTP server over localhost with a
small COATI and a small COATI2, the same weights as coati_tpu's: every
endpoint against in-process calls of both packages (embeddings atol 3e-5,
rtol 1e-4; greedy SMILES exactly), a bad SMILES among co-batched good
ones, the 400s and the 500, continuous mode for both families (greedy
/generate equal to the micro-batched path), and two replicas answering as
one device does.

Every wait has its own limit: Future.result(timeout), urlopen(timeout),
join(timeout) followed by a check that the thread ended, and stop() /
close() in finally."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from coati_tpu.models import coati2 as j2
from coati_tpu.models.api import COATI as JaxCOATI
from coati_tpu.models.io import params_to_state
from coati_tpu.tokenizers.trie_tokenizer import TrieTokenizer as JaxTokenizer

from coati_tpu_torch.models import coati2 as t2
from coati_tpu_torch.models.api import COATI
from coati_tpu_torch.models.convert import coati2_state_from_coati_tpu
from coati_tpu_torch.parallel.inference import ShardedCOATI
from coati_tpu_torch.serving import CoatiInferenceServer, ContinuousService, MicroBatcher
from coati_tpu_torch.tokenizers import get_vocab
from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
from tests import torch_port_helpers as hp
from tests.torch_port_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_SEQ = 32
SMILES = ["CCO", "CC(=O)O", "c1ccccc1", "CCN", "OCC(=O)c1ccccc1", "CC#N"]
TIMEOUT = 60


# ----------------------------------------------------------- MicroBatcher


def test_batcher_coalesces_concurrent_submits():
    seen = []

    def batch_fn(items):
        seen.append(len(items))
        time.sleep(0.01)
        return [x * 2 for x in items]

    b = MicroBatcher(batch_fn, max_batch=64, flush_ms=50)
    try:
        futs = [b.submit(i) for i in range(20)]
        assert [f.result(timeout=TIMEOUT) for f in futs] == [2 * i for i in range(20)]
        assert sum(seen) == 20 and len(seen) <= 3
    finally:
        b.close()
    assert not b._worker.is_alive()


def test_batcher_respects_max_batch():
    seen = []

    def batch_fn(items):
        seen.append(len(items))
        return items

    b = MicroBatcher(batch_fn, max_batch=4, flush_ms=100)
    try:
        futs = [b.submit(i) for i in range(10)]
        assert [f.result(timeout=TIMEOUT) for f in futs] == list(range(10))
        assert max(seen) <= 4 and sum(seen) == 10
    finally:
        b.close()


def test_batcher_fails_the_batch_and_lives_on():
    """A raising batch function fails that batch's futures; the next batch
    is served; a closed batcher refuses submits."""
    calls = []

    def batch_fn(items):
        calls.append(list(items))
        if "bad" in items:
            raise ValueError("bad item")
        return [x.upper() for x in items]

    b = MicroBatcher(batch_fn, max_batch=8, flush_ms=30)
    try:
        futs = [b.submit(x) for x in ("a", "bad", "c")]
        for f in futs:
            with pytest.raises(ValueError, match="bad item"):
                f.result(timeout=TIMEOUT)
        assert b.submit("d").result(timeout=TIMEOUT) == "D"
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit("e")


# ------------------------------------------------------------------ server


def _post(server, path, body, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=raw if raw is not None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.loads(resp.read())


def _status(server, path, body, raw=None):
    """(HTTP status, JSON body) of a request expected to fail."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, path, body, raw)
    return err.value.code, json.loads(err.value.read())


@pytest.fixture(scope="module")
def coati_pair():
    """coati_tpu's and the port's COATI with the same weights (2 x 32,
    mar_verysimple) and their tokenizers."""
    jparams, jcfg, module, tcfg = hp.model_pair(seed=5, n_seq=N_SEQ)
    jtok = JaxTokenizer(n_seq=N_SEQ, **get_vocab("mar_verysimple"))
    return JaxCOATI(jparams, jcfg), jtok, COATI(module, tcfg), hp.tokenizer(N_SEQ)


@pytest.fixture(scope="module")
def server(coati_pair):
    _, _, model, tok = coati_pair
    srv = CoatiInferenceServer(model, tok, port=0, flush_ms=30)
    srv.warmup(max_bucket=8, gen_params=((1, 2.0),), verbose=False)
    srv.start()
    try:
        yield srv
    finally:
        srv.stop()


def _token_rows(tok, smiles):
    return np.asarray([tok.tokenize_text("[SMILES]" + s + "[STOP]", pad=True) for s in smiles])


def test_healthz_names_the_device(server):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz",
                                timeout=TIMEOUT) as resp:
        body = json.loads(resp.read())
    assert body == {"status": "ok", "model": "coati", "embed_dim": 32, "device": "cpu"}
    assert _status(server, "/nothing", {})[0] == 404


def test_embed_equals_in_process_encodes_of_both_packages(server, coati_pair):
    jmodel, jtok, model, tok = coati_pair
    h = np.asarray(_post(server, "/embed", {"smiles": SMILES})["embeddings"], np.float32)
    assert h.shape == (len(SMILES), 32)
    hp.close(h, model.encode_tokens(_token_rows(tok, SMILES), tok).numpy())
    hp.close(h, np.asarray(jmodel.encode_tokens(_token_rows(jtok, SMILES), jtok)))


def test_generate_and_analogs_equal_in_process_decodes(server, coati_pair):
    """Greedy /generate gives hclip_to_2d_batch's SMILES in both packages;
    /analogs gives n_analogs strings for each input."""
    jmodel, jtok, model, tok = coati_pair
    h = _post(server, "/embed", {"smiles": SMILES})["embeddings"]
    out = _post(server, "/generate", {"embeddings": h, "k": 1})["smiles"]
    assert out == model.hclip_to_2d_batch(np.asarray(h, np.float32), tok, k=1)
    assert out == jmodel.hclip_to_2d_batch(np.asarray(h, np.float32), jtok, k=1)
    analogs = _post(server, "/analogs", {"smiles": SMILES[:2], "n_analogs": 3, "k": 4,
                                         "noise_scale": 0.5})["analogs"]
    assert [len(a) for a in analogs] == [3, 3]
    assert all(isinstance(s, str) for a in analogs for s in a)


def test_concurrent_clients_share_batches(server, coati_pair):
    _, _, model, tok = coati_pair
    results, errors = [None] * 12, []

    def client(i):
        try:
            results[i] = _post(server, "/embed", {"smiles": [SMILES[i % 6]]})["embeddings"][0]
        except Exception as ex:  # noqa: BLE001 - collected for the assert
            errors.append(ex)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert not errors
    ref = model.encode_tokens(_token_rows(tok, SMILES), tok).numpy()
    for i, row in enumerate(results):
        hp.close(np.asarray(row, np.float32), ref[i % 6])


def test_bad_smiles_fails_only_its_own_request(server, coati_pair):
    """An oversized and an untokenizable SMILES each get 400 while
    concurrent good requests get their embeddings."""
    _, _, model, tok = coati_pair
    good, codes, errors = [], [], []

    def send(smiles):
        try:
            good.append(_post(server, "/embed", {"smiles": smiles})["embeddings"])
        except urllib.error.HTTPError as ex:
            codes.append(ex.code)
        except Exception as ex:  # noqa: BLE001 - collected for the assert
            errors.append(ex)

    batches = [["CCO"], ["C" * 500], ["CC"], ["C[Zz]C"], ["CCO"]]
    threads = [threading.Thread(target=send, args=(b,)) for b in batches]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert not errors and sorted(codes) == [400, 400] and len(good) == 3
    ref = {s: model.encode_tokens(_token_rows(tok, [s]), tok).numpy()[0] for s in ("CCO", "CC")}
    for rows in good:
        assert any(np.allclose(rows[0], r, atol=3e-5) for r in ref.values())


def test_refusals_are_400_and_model_failures_500(server, monkeypatch):
    assert _status(server, "/embed", None, raw=b"{not json")[0] == 400
    assert _status(server, "/embed", {"smile": ["CCO"]})[0] == 400
    assert _status(server, "/embed", {"smiles": [3]})[0] == 400
    assert _status(server, "/generate", {"embeddings": [[1.0, 2.0]]})[0] == 400
    assert _status(server, "/generate", {"embeddings": [[0.0] * 32], "k": "many"})[0] == 400
    assert _status(server, "/generate", {"embeddings": [[0.0] * 32], "k": 0})[0] == 400

    def fail(*args, **kwargs):
        raise RuntimeError("decode kernel failed")

    monkeypatch.setattr(server.frontend.model, "hclip_to_2d_batch", fail)
    code, body = _status(server, "/generate", {"embeddings": [[0.0] * 32], "k": 1})
    assert code == 500 and "decode kernel failed" in body["error"]


def test_generation_configs_are_bounded(coati_pair):
    _, _, model, tok = coati_pair
    srv = CoatiInferenceServer(model, tok, port=0)
    srv.MAX_GEN_PROGRAMS = 2
    srv.start()
    try:
        h = [[0.1] * 32]
        for k in (1, 2):
            assert len(_post(srv, "/generate", {"embeddings": h, "k": k})["smiles"]) == 1
        code, body = _status(srv, "/generate", {"embeddings": h, "k": 3})
        assert code == 400 and "too many" in body["error"]
    finally:
        srv.stop()


def test_model_calls_from_the_batchers_are_serialized(coati_pair, monkeypatch):
    """The embed batcher and a generate batcher for each (k, inv_temp) run in
    threads of their own, and the model holds one torch.Generator: the
    frontend lets one call at a time into the model."""
    _, _, model, tok = coati_pair
    inside, most = [0], [0]
    guard = threading.Lock()

    def counted(fn):
        def call(*args, **kwargs):
            with guard:
                inside[0] += 1
                most[0] = max(most[0], inside[0])
            time.sleep(0.05)  # long enough for the other batchers' calls to arrive
            try:
                return fn(*args, **kwargs)
            finally:
                with guard:
                    inside[0] -= 1
        return call

    for name in ("encode_tokens", "hclip_to_2d_batch"):
        monkeypatch.setattr(model, name, counted(getattr(model, name)))
    srv = CoatiInferenceServer(model, tok, port=0, flush_ms=5)
    srv.start()
    errors = []

    def send(path, body):
        try:
            _post(srv, path, body)
        except Exception as ex:  # noqa: BLE001 - collected for the assert
            errors.append(ex)

    jobs = [("/embed", {"smiles": [s]}) for s in SMILES[:3]]
    jobs += [("/generate", {"embeddings": [[0.1] * 32], "k": k}) for k in (1, 2, 3)]
    try:
        threads = [threading.Thread(target=send, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        srv.stop()
    assert not errors and most[0] == 1


def test_server_with_two_replicas_answers_as_one_device(server, coati_pair):
    """mesh of two devices: the model is wrapped in ShardedCOATI, one
    replica a device, and /embed and greedy /generate answer as the
    one-device server does (an odd number of rows pads the last replica);
    continuous mode over two devices takes them too."""
    _, _, model, tok = coati_pair
    srv = CoatiInferenceServer(model, tok, port=0, flush_ms=30, mesh=["cpu", "cpu"])
    assert isinstance(srv.frontend.model, ShardedCOATI) and srv.frontend.model.n_devices == 2
    srv.start()
    try:
        smiles = SMILES[:5]
        h = _post(srv, "/embed", {"smiles": smiles})["embeddings"]
        hp.close(np.asarray(h, np.float32),
                 np.asarray(_post(server, "/embed", {"smiles": smiles})["embeddings"]))
        out = _post(srv, "/generate", {"embeddings": h, "k": 1})["smiles"]
        assert out == _post(server, "/generate", {"embeddings": h, "k": 1})["smiles"]
    finally:
        srv.stop()
    srv = CoatiInferenceServer(model, tok, mesh=[torch.device("cpu"), torch.device("cpu")],
                               continuous=True)
    assert isinstance(srv.frontend.model, ShardedCOATI) and srv._devices == [
        torch.device("cpu")] * 2


# -------------------------------------------------------- continuous mode


def _continuous_round(model, tok, h, mesh=None):
    """Greedy /generate of h through a continuous server, and the batcher
    its (k, inv_temp) got; the top_p request goes to a micro-batcher."""
    srv = CoatiInferenceServer(model, tok, port=0, continuous=True, n_slots=4, mesh=mesh)
    srv.start()
    try:
        out = _post(srv, "/generate", {"embeddings": h, "k": 1})["smiles"]
        assert isinstance(srv._gen_batcher(1, 2.0), ContinuousService)
        nucleus = _post(srv, "/generate", {"embeddings": h[:2], "k": 4, "top_p": 0.9})["smiles"]
        assert len(nucleus) == 2 and isinstance(srv._gen_batcher(4, 2.0, 0.9), MicroBatcher)
        return out
    finally:
        srv.stop()


def test_continuous_mode_equals_micro_batched_greedy_coati(coati_pair):
    _, _, model, tok = coati_pair
    h = model.encode_tokens(_token_rows(tok, SMILES), tok).numpy()
    h = np.concatenate([h, h * 1.5]).tolist()  # 12 requests over 4 slots
    out = _continuous_round(model, tok, h)
    assert out == model.hclip_to_2d_batch(np.asarray(h, np.float32), tok, k=1)


def test_continuous_mode_over_two_devices_answers_as_one_device(coati_pair):
    """continuous=True over ["cpu", "cpu"]: the slot pool split over the two
    devices, each applying its replica's token MLP; greedy /generate equals
    the one-device model's decode, row for row."""
    _, _, model, tok = coati_pair
    h = model.encode_tokens(_token_rows(tok, SMILES), tok).numpy()
    h = np.concatenate([h, h * 1.5]).tolist()  # 12 requests over 4 slots
    out = _continuous_round(model, tok, h, mesh=["cpu", "cpu"])
    assert out == model.hclip_to_2d_batch(np.asarray(h, np.float32), tok, k=1)


def test_continuous_mode_equals_micro_batched_greedy_coati2():
    kw = dict(n_layer_xformer=2, n_hidden_xformer=32, embed_dim=32, n_head=2, n_seq=N_SEQ,
              n_tok=TrieTokenizer(n_seq=N_SEQ, **get_vocab("coati2_12_12")).n_token)
    jcfg = j2.Coati2Config(precision="highest", **kw)
    jparams = j2.init_coati2(jax.random.PRNGKey(3), jcfg)
    tcfg = t2.Coati2Config(**kw)
    module = t2.Coati2Model(tcfg)
    module.load_state_dict(coati2_state_from_coati_tpu(params_to_state(jparams),
                                                       tcfg.enc_to_coati))
    tok = TrieTokenizer(n_seq=N_SEQ, **get_vocab("coati2_12_12"))
    model = t2.COATI2(module, tcfg)
    h = (np.random.default_rng(4).normal(size=(6, 32)) * 2).astype(np.float32)
    out = _continuous_round(model, tok, h.tolist())
    assert out == model.hcoati_to_2d_batch(h, tok, k=1)
    jtok = JaxTokenizer(n_seq=N_SEQ, **get_vocab("coati2_12_12"))
    assert out == j2.COATI2(jparams, jcfg).hcoati_to_2d_batch(h, jtok, k=1)
