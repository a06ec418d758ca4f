"""What the inference drivers share: the model under test built from a
configuration, requests of corpus SMILES drawn from the seed, and the
tokenizer wrapper that keeps the token rows a call returns."""

from __future__ import annotations

import gzip

import numpy as np

from portbench.harness import ROOT
from portbench.reference import weights


def load_corpus(path: str) -> list:
    with gzip.open(ROOT / path, "rt") as f:
        return [line.strip() for line in f if line.strip()]


class RequestPool:
    """Requests of `rows` SMILES each. The corpus (rows of at most
    `max_chars` characters) is cut by length into `rows` strata of equal
    count; request i takes one molecule from each stratum, by a permutation
    of the stratum the seed draws, so that no molecule repeats until a
    stratum is used up and every request holds the same spread of
    lengths."""

    def __init__(self, corpus: list, rows: int, seed: int, max_chars: int):
        kept = [s for s in corpus if len(s) <= max_chars]
        order = np.argsort([len(s) for s in kept], kind="stable")
        edges = np.linspace(0, len(kept), rows + 1).astype(int)
        rng = np.random.default_rng(seed)
        self.corpus = kept
        self.strata = [order[a:b][rng.permutation(b - a)] for a, b in zip(edges, edges[1:])]

    def indices(self, i: int) -> np.ndarray:
        return np.array([s[i % len(s)] for s in self.strata])

    def smiles(self, i: int) -> list:
        return [self.corpus[j] for j in self.indices(i)]


class RecordingTokenizer:
    """The program's tokenizer, passed to its calls in place of itself: it
    keeps the token rows the call hands back for detokenizing."""

    def __init__(self, tokenizer):
        self._tokenizer = tokenizer
        self.last = None

    def decode_batch(self, rows, *args, **kwargs):
        self.last = np.asarray(rows)
        return self._tokenizer.decode_batch(rows, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._tokenizer, name)


def token_rows(tokenizer, smiles: list) -> np.ndarray:
    """'[SMILES]<s>[STOP]' rows padded to the tokenizer's n_seq, as the
    program's callers tokenize."""
    return np.asarray([tokenizer.tokenize_text("[SMILES]" + s + "[STOP]", pad=True)
                       for s in smiles])


def build_model(cfg: dict, seed: int, device):
    """(model under test in the configuration's precision, tokenizer) on
    `device`: the configuration's document, or weights drawn from `seed`
    with the benchmark's own initialiser."""
    source = cfg["weights"]
    if cfg["family"] == "coati2":
        from coati_tpu_torch.models.coati2 import COATI2
        from coati_tpu_torch.models.io import load_coati2

        tree = weights.seeded(cfg, seed, device)
        loaded, tok = load_coati2(weights.document(tree, cfg), device=device)
        del tree
        model = COATI2(loaded.params, loaded.config.replace(dtype=cfg["dtype"]), seed=seed)
        return model, tok
    from coati_tpu_torch.models.api import COATI
    from coati_tpu_torch.models.io import load_e3gnn_smiles_clip_e2e

    doc = str(ROOT / source["document"]) if "document" in source else \
        weights.document(weights.seeded(cfg, seed, device), cfg)
    loaded, tok = load_e3gnn_smiles_clip_e2e(doc, device=device)
    config = loaded.config.replace(dtype=cfg["dtype"], kv_dtype=cfg["kv_dtype"],
                                   kv_scale_dtype=cfg["kv_scale_dtype"])
    return COATI(loaded.params, config, seed=seed), tok


def reference_weights(cfg: dict, seed: int, device) -> dict:
    """The weights the reference computes with: the document read by the
    reference itself, or the same draw from the seed."""
    source = cfg["weights"]
    if "document" in source:
        return weights.load_document(str(ROOT / source["document"]), device)
    return weights.seeded(cfg, seed, device)


def same_model(model, seed: int):
    """A second handle on the model under test with its own sampling
    stream, seeded: two handles of one seed make the same draws."""
    return type(model)(model.params, model.config, seed=seed)
