"""HTTP inference server over a COATI / COATI2 model.

Counterpart of coati_tpu/serving/server.py. It serves the two production
workloads, SMILES -> embedding and embedding -> SMILES, behind
micro-batching (batcher.py) so that concurrent callers share device work.
stdlib only (ThreadingHTTPServer + JSON).

Endpoints (all JSON):
  GET  /healthz                  -> {"status": "ok", "model": ..., "embed_dim": ...,
                                     "device": <the torch device's name>}
  POST /embed    {"smiles": [...]}
      -> {"embeddings": [[...], ...]}   (a SMILES the tokenizer refuses
                                         gives 400 with the detail)
  POST /generate {"embeddings": [[...]], "k": 100, "inv_temp": 2.0,
                  "noise_scale": 0.0, "top_p": null}
      -> {"smiles": [...]}
  POST /analogs  {"smiles": [...], "noise_scale": 0.3, "n_analogs": 4,
                  "k": 100, "inv_temp": 2.0}
      -> {"analogs": [[...n_analogs per input...], ...]}  (embed -> noisy
         decode round trip, the tutorial.ipynb workflow as a service)

A request the server cannot take (malformed JSON, a missing or ill-typed
field, a SMILES the tokenizer refuses, embeddings of the wrong width, too
many sampling configurations) is refused with 400 before anything of it
reaches the model, so a bad SMILES fails its own request and not the
requests batched with it. Any error after that (a decode or a kernel that
fails) reaches the caller as 500 with its detail.

Generation parameters are part of the batch key: requests batch together
only when (k, inv_temp, top_p) agree. noise_scale is applied on the host
per request, so every noise level co-batches.

Threads: the HTTP handlers, the embed batcher and one batcher per sampling
configuration run in their own threads. The model's calls from the
batchers are serialized by one lock in _ModelFrontend: the model holds one
torch.Generator, and concurrent decodes would interleave its draws. A
continuous engine (continuous=True) holds its own generator and its own
cache and runs beside them; it shares with the model only parameters,
which no call writes.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from coati_tpu_torch.serving.batcher import MicroBatcher
from coati_tpu_torch.serving.continuous import ContinuousDecoder, ContinuousService, mesh_devices

# seconds a request waits for its rows before the server answers 500
REQUEST_TIMEOUT_S = 600.0


_REQUIRED = object()


class BadRequest(ValueError):
    """A request the server refuses with 400."""


def _field(body: dict, name: str, kind, default=_REQUIRED):
    """body[name] converted by `kind`, or `default` when it is missing or
    null; missing without a default, or unconvertible -> BadRequest."""
    if not isinstance(body, dict):
        raise BadRequest("the request body must be a JSON object")
    if body.get(name) is None:
        if default is _REQUIRED:
            raise BadRequest(f"missing field {name!r}")
        return default
    try:
        return kind(body[name])
    except (TypeError, ValueError) as ex:
        raise BadRequest(f"field {name!r}: {ex}") from ex


class _ModelFrontend:
    """Model-type dispatch: COATI (models/api.py) or COATI2
    (models/coati2.py) behind one embed / generate surface. `lock`
    serializes the calls into the model."""

    def __init__(self, model, tokenizer):
        self.model = model
        self.tokenizer = tokenizer
        self.is_coati2 = hasattr(model, "hcoati_to_2d_batch")
        self.embed_dim = model.embed_dim
        self.lock = threading.Lock()

    def tokenize(self, smiles: str) -> np.ndarray:
        """Host-side tokenization, done per request (not in the batch
        worker) so that a malformed or oversized SMILES is refused in its
        own request instead of failing the requests batched with it."""
        if not isinstance(smiles, str):
            raise BadRequest(f"a SMILES must be a string, got {type(smiles).__name__}")
        try:
            ids = self.tokenizer.tokenize_text("[SMILES]" + smiles + "[STOP]", pad=True)
        except (KeyError, ValueError) as ex:
            raise BadRequest(f"{smiles!r}: {type(ex).__name__}: {ex}") from ex
        return np.asarray(ids, np.int64)

    def embed_rows(self, token_rows) -> np.ndarray:
        tokens = np.stack(token_rows)
        with self.lock:
            return self.model.encode_tokens(tokens, self.tokenizer).float().cpu().numpy()

    def generate(self, h, k, inv_temp, noise_scale=0.0, top_p=None):
        h = np.asarray(h, np.float32)
        decode = self.model.hcoati_to_2d_batch if self.is_coati2 else self.model.hclip_to_2d_batch
        with self.lock:
            return decode(h, self.tokenizer, noise_scale=noise_scale, inv_temp=inv_temp, k=k,
                          top_p=top_p)


class CoatiInferenceServer:
    """Micro-batched HTTP server. Usage:

        server = CoatiInferenceServer(model, tokenizer, port=8000)
        server.warmup()         # builds the kernels before traffic
        server.start()          # returns at once (daemon threads)
        ...
        server.stop()

    port=0 picks a free port (server.port after start()). The model runs
    on its own device (the card, as loaded by models/io.py)."""

    # distinct (k, inv_temp, top_p) configurations each own a batcher and
    # its thread (and in continuous mode a slot pool on the card); bounded
    # so that clients cannot grow them without limit
    MAX_GEN_PROGRAMS = 32

    def __init__(
        self,
        model,
        tokenizer,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 256,
        flush_ms: float = 20.0,
        mesh=None,
        continuous: bool = False,
        n_slots: int = 64,
    ):
        """mesh: None, a device, or a list of devices. Several devices wrap
        the model in ShardedCOATI / ShardedCOATI2 (parallel/inference.py):
        one replica a device, each request batch split evenly over them; in
        continuous mode each slot pool is split over them too
        (ContinuousDecoder(mesh=...)).

        continuous: serve /generate through ContinuousDecoder slot pools
        (n_slots rows per (k, inv_temp)) instead of drain-the-cohort
        micro-batches: a finished molecule returns at the next segment
        boundary instead of waiting for the longest co-batched one. Both
        model families (COATI's clip_to_special_token, COATI2's
        coati_to_token as the injection transform); requests with top_p go
        to the micro-batcher."""
        devices = [] if mesh is None else mesh_devices(mesh, None)
        self._devices = devices if len(devices) > 1 else None
        if self._devices:
            from coati_tpu_torch.parallel.inference import shard_model

            model = shard_model(model, devices)
        self._continuous = continuous
        self._n_slots = n_slots
        self.frontend = _ModelFrontend(model, tokenizer)
        self.host = host
        self.port = port
        self._embed_batcher = MicroBatcher(
            self.frontend.embed_rows, max_batch=max_batch, flush_ms=flush_ms,
            name="embed-batcher",
        )
        self._noise = np.random.default_rng(0)
        self._noise_lock = threading.Lock()  # numpy Generators are not thread-safe
        self._gen_batchers: dict = {}
        self._gen_lock = threading.Lock()
        self._max_batch = max_batch
        self._flush_ms = flush_ms
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _gen_batcher(self, k: int, inv_temp: float, top_p=None):
        # noise is applied on the host per request (op_generate), so it is
        # not part of the key: every noise level co-batches
        key = (int(k), float(inv_temp), None if top_p is None else float(top_p))
        with self._gen_lock:
            if key not in self._gen_batchers:
                if len(self._gen_batchers) >= self.MAX_GEN_PROGRAMS:
                    raise BadRequest(
                        f"too many distinct (k, inv_temp, top_p) configs "
                        f"(> {self.MAX_GEN_PROGRAMS}); reuse existing ones"
                    )
                if self._continuous and top_p is None:
                    self._gen_batchers[key] = self._make_continuous(key[0], key[1])
                else:
                    fe = self.frontend

                    def gen_fn(rows, _key=key):
                        kk, it, tp = _key
                        return fe.generate(np.stack(rows), kk, it, 0.0, top_p=tp)

                    self._gen_batchers[key] = MicroBatcher(
                        gen_fn, max_batch=self._max_batch, flush_ms=self._flush_ms,
                        name=f"gen-batcher{key}",
                    )
            return self._gen_batchers[key]

    def _make_continuous(self, k: int, inv_temp: float) -> ContinuousService:
        """A warmed-up slot pool for one (k, inv_temp). Both families ride
        the same engine: their decode surfaces share the [CLIP][UNK][SMILES]
        prefix and the injection over [UNK]; the model's own embedding ->
        token map (`_to_token`) is the injection transform."""
        model, tok = self.frontend.model, self.frontend.tokenizer
        # over several devices each device's replica decodes and maps its
        # share of the pool
        replicas = getattr(model, "replicas", [model])
        by_device = {r.device: r for r in replicas}
        model = getattr(model, "model", model)
        xcfg = model.config.xformer_config
        prefix = list(tok.tokenize_text("[CLIP][UNK][SMILES]", pad=False))

        def inj_transform(h):
            return by_device[h.device]._to_token(h.to(xcfg.compute_dtype))

        engine = ContinuousDecoder(
            [r._compute.xformer for r in replicas], xcfg, prefix,
            n_slots=self._n_slots,
            stop_token=tok.stop_token, pad_token=tok.pad_token,
            inject_token=tok.unk_token, k=k, inv_temp=inv_temp,
            inj_transform=inj_transform, inj_dim=model.embed_dim, mesh=self._devices,
        )
        engine.warmup()

        def decode_fn(tokens):
            tokens = [int(t) for t in tokens]
            if len(tokens) == engine.w and tokens[-1] != tok.stop_token:
                # a row that reached total_len without [STOP]: the sampler of
                # the micro-batched path ends it with [STOP] there, and so
                # does this one, so that both modes give the same string
                tokens[-1] = tok.stop_token
            return tok.decode(tokens[len(prefix):], special=False)

        return ContinuousService(engine, decode_fn, name=f"continuous-{k}-{inv_temp}")

    # ------------------------------------------------------- request ops

    @staticmethod
    def _results(futures) -> list:
        return [f.result(timeout=REQUEST_TIMEOUT_S) for f in futures]

    def op_embed(self, body: dict) -> dict:
        smiles = _field(body, "smiles", list)
        rows = [self.frontend.tokenize(s) for s in smiles]  # may refuse with 400
        futs = [self._embed_batcher.submit(r) for r in rows]
        return {"embeddings": [e.tolist() for e in self._results(futs)]}

    def op_generate(self, body: dict) -> dict:
        try:
            h = np.asarray(_field(body, "embeddings", list), np.float32)
        except ValueError as ex:
            raise BadRequest(f"embeddings: {ex}") from ex
        if h.ndim != 2 or h.shape[1] != self.frontend.embed_dim:
            raise BadRequest(f"embeddings must be (n, {self.frontend.embed_dim})")
        k = _field(body, "k", int, 100)
        inv_temp = _field(body, "inv_temp", float, 2.0)
        noise_scale = _field(body, "noise_scale", float, 0.0)
        top_p = _field(body, "top_p", float, None)
        if k < 1:
            raise BadRequest(f"k must be >= 1, got {k}")
        if noise_scale > 0:
            with self._noise_lock:
                noise = self._noise.normal(scale=noise_scale, size=h.shape)
            h = h + noise.astype(np.float32)
        batcher = self._gen_batcher(k, inv_temp, top_p)
        futs = [batcher.submit(row) for row in h]
        return {"smiles": self._results(futs)}

    def op_analogs(self, body: dict) -> dict:
        smiles = _field(body, "smiles", list)
        n_analogs = _field(body, "n_analogs", int, 4)
        emb = self.op_embed({"smiles": smiles})["embeddings"]
        h = np.repeat(np.asarray(emb, np.float32), n_analogs, axis=0)
        out = self.op_generate({
            "embeddings": h.tolist(),
            "k": body.get("k", 100),
            "inv_temp": body.get("inv_temp", 2.0),
            "noise_scale": body.get("noise_scale", 0.3),
            "top_p": body.get("top_p"),
        })["smiles"]
        return {"analogs": [out[i * n_analogs : (i + 1) * n_analogs] for i in range(len(smiles))]}

    # ---------------------------------------------------------- lifecycle

    def device_name(self) -> str:
        device = self.frontend.model.device
        if device.type == "cuda":
            return torch.cuda.get_device_name(device)
        return str(device)

    def warmup(self, max_bucket: int = 256, gen_params: tuple = ((100, 2.0),),
               verbose: bool = True) -> None:
        """Build the kernels and touch every path before serving: one embed
        of `max_bucket` rows and, for each (k, inv_temp) or (k, inv_temp,
        top_p) of gen_params, one generate of them (in continuous mode the
        slot pool is made and warmed up instead). A kernel built under live
        traffic would stall every request waiting on it."""
        t0 = time.perf_counter()
        h = self.frontend.embed_rows([self.frontend.tokenize("CCO")] * max_bucket)
        for entry in gen_params:
            k, inv_temp, *rest = entry
            top_p = rest[0] if rest else None
            if self._continuous and top_p is None:
                self._gen_batcher(k, inv_temp)
            else:
                self.frontend.generate(h, k, inv_temp, 0.0, top_p=top_p)
        if verbose:
            print(f"warmup: {time.perf_counter() - t0:.1f}s", flush=True)

    def start(self) -> None:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, code: int, payload: dict):
                blob = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(blob)))
                self.end_headers()
                self.wfile.write(blob)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {
                        "status": "ok",
                        "model": "coati2" if server.frontend.is_coati2 else "coati",
                        "embed_dim": server.frontend.embed_dim,
                        "device": server.device_name(),
                    })
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                ops = {"/embed": server.op_embed, "/generate": server.op_generate,
                       "/analogs": server.op_analogs}
                op = ops.get(self.path)
                if op is None:
                    self._send(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as ex:
                    self._send(400, {"error": f"malformed JSON: {ex}"})
                    return
                try:
                    result = op(body)
                except BadRequest as ex:
                    self._send(400, {"error": str(ex)})
                except Exception as ex:  # noqa: BLE001 - the client gets a 500 with the detail
                    self._send(500, {"error": f"{type(ex).__name__}: {ex}"})
                else:
                    self._send(200, result)

        class _Server(ThreadingHTTPServer):
            # socketserver's default accept backlog of 5 drops bursts of
            # concurrent connections (ConnectionResetError on the client)
            request_queue_size = 1024
            daemon_threads = True

        self._httpd = _Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="coati-http",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
        self._embed_batcher.close()
        for b in self._gen_batchers.values():
            b.close()
