"""Serve a COATI / COATI2 model document over HTTP (micro-batched).

Usage:
    python -m coati_tpu_torch.examples.serve --doc_url /path/to/model.pkl [--port 8000]
    python -m coati_tpu_torch.examples.serve --doc_url ... --coati2   # COATI2 document
    python -m coati_tpu_torch.examples.serve --tiny                   # random tiny model
    python -m coati_tpu_torch.examples.serve --tiny --requests 4      # answer 4 rounds, stop

Then:
    curl localhost:8000/healthz
    curl -X POST localhost:8000/embed -d '{"smiles": ["CCO"]}'
    curl -X POST localhost:8000/analogs \
         -d '{"smiles": ["CCO"], "n_analogs": 4, "noise_scale": 0.3}'
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request

from coati_tpu_torch.examples import DEVICE_HELP

CHECK_SMILES = ["CCO", "c1ccccc1O", "CC(=O)Nc1ccc(O)cc1", "CC(C)Cc1ccc(cc1)C(C)C(=O)O"]


def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return json.loads(resp.read())


def check_rounds(port: int, rounds: int) -> dict:
    """`rounds` rounds of /healthz, /embed, /generate and /analogs on the
    server at `port` from this process; seconds of each endpoint."""
    seconds = {"healthz": [], "embed": [], "generate": [], "analogs": []}
    out = {}
    for _ in range(rounds):
        t0 = time.perf_counter()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            out["healthz"] = json.loads(resp.read())
        t1 = time.perf_counter()
        emb = _post(port, "/embed", {"smiles": CHECK_SMILES})["embeddings"]
        t2 = time.perf_counter()
        out["generated"] = _post(port, "/generate", {"embeddings": emb})["smiles"]
        t3 = time.perf_counter()
        out["analogs"] = _post(port, "/analogs", {"smiles": CHECK_SMILES[:2], "n_analogs": 4,
                                                  "noise_scale": 0.3})["analogs"]
        t4 = time.perf_counter()
        for key, dt in zip(seconds, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            seconds[key].append(dt)
    out["embeddings"] = emb
    out["seconds"] = seconds
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="COATI inference server")
    parser.add_argument("--doc_url", type=str, default=None)
    parser.add_argument("--coati2", action="store_true")
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny model (mechanics smoke test)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=256)
    parser.add_argument("--flush_ms", type=float, default=20.0)
    parser.add_argument("--requests", type=int, default=0,
                        help="answer this many rounds of requests from this process, then "
                             "stop (0: serve until interrupted)")
    parser.add_argument("--device", default=None, help=DEVICE_HELP)
    args = parser.parse_args(argv)

    if args.tiny:
        from coati_tpu_torch.common.util import resolve_device
        from coati_tpu_torch.models.api import COATI
        from coati_tpu_torch.models.coati import CoatiConfig
        from coati_tpu_torch.tokenizers import get_vocab
        from coati_tpu_torch.tokenizers.trie_tokenizer import TrieTokenizer
        from coati_tpu_torch.training.train import fresh_model

        tokenizer = TrieTokenizer(n_seq=64, **get_vocab("mar"))
        cfg = CoatiConfig(
            n_layer_e3gnn=2, n_layer_xformer=3, n_hidden_xformer=64,
            n_hidden_e3nn=64, n_embd_common=64, n_head=4, n_seq=64,
            n_tok=tokenizer.n_token, norm_clips=True, token_mlp=True,
        )
        model = COATI(fresh_model(cfg, resolve_device(args.device)).eval(), cfg)
    elif args.coati2:
        from coati_tpu_torch.models.io import load_coati2

        model, tokenizer = load_coati2(args.doc_url, device=args.device)
    else:
        from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

        model, tokenizer = load_e3gnn_smiles_clip_e2e(args.doc_url, device=args.device)

    from coati_tpu_torch.serving.server import CoatiInferenceServer

    server = CoatiInferenceServer(
        model, tokenizer, host=args.host, port=args.port,
        max_batch=args.max_batch, flush_ms=args.flush_ms,
    )
    print("warming up the batch ladder...")
    server.warmup(max_bucket=args.max_batch)
    server.start()
    print(f"serving on http://{args.host}:{server.port} "
          f"(max_batch {args.max_batch}, flush {args.flush_ms} ms)")
    try:
        if args.requests:
            out = check_rounds(server.port, args.requests)
            print(f"answered {args.requests} rounds: "
                  + ", ".join(f"{k} {max(v):.3f} s" for k, v in out["seconds"].items()))
            return out
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return {}


if __name__ == "__main__":
    main()
