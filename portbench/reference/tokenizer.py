"""Tokens of SMILES text, worked out by the reference itself.

A vocabulary file ({"special_tokens": [...], "smiles_tokens": [...]}) gives
ids in that order, special tokens first. Text splits first on special
tokens and then on SMILES tokens, each scan leftmost-longest: at every
position the longest vocabulary token that starts there.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

VOCAB_DIR = Path(__file__).resolve().parents[2] / "coati_tpu_torch" / "tokenizers" / "vocabs"


class Vocabulary:
    def __init__(self, name: str):
        data = json.loads((VOCAB_DIR / f"{name}.json").read_text())
        self.special = [t.strip() for t in data["special_tokens"]]
        keys = self.special + [t.strip() for t in data["smiles_tokens"]]
        self.ids = {t: i for i, t in enumerate(keys)}
        self.n_token = len(keys)
        self._special = set(self.special)
        self._smiles_by_first = self._index(data["smiles_tokens"])
        self._special_by_first = self._index(data["special_tokens"])
        for name_ in ("STOP", "PAD", "CLIP", "UNK", "SMILES"):
            setattr(self, name_.lower(), self.ids[f"[{name_}]"])

    @staticmethod
    def _index(tokens):
        out: dict = {}
        for t in tokens:
            t = t.strip()
            if t:
                out.setdefault(t[0], set()).add(t)
        return {c: sorted(ts, key=len, reverse=True) for c, ts in out.items()}

    @staticmethod
    def _split(text: str, by_first: dict):
        out, i, plain = [], 0, ""
        while i < len(text):
            match = next((t for t in by_first.get(text[i], ()) if text.startswith(t, i)), None)
            if match is None:
                plain += text[i]
                i += 1
                continue
            if plain:
                out.append(plain)
                plain = ""
            out.append(match)
            i += len(match)
        return out + ([plain] if plain else [])

    def encode(self, text: str) -> list:
        pieces = []
        for piece in self._split(text, self._special_by_first):
            pieces += [piece] if piece in self._special else self._split(piece, self._smiles_by_first)
        return [self.ids[p] for p in pieces]

    def smiles_rows(self, smiles, width: int) -> np.ndarray:
        """(B, width) '[SMILES]<s>[STOP]' rows padded with [PAD]."""
        out = np.full((len(smiles), width), self.pad, np.int64)
        for i, s in enumerate(smiles):
            ids = self.encode("[SMILES]" + s + "[STOP]")
            out[i, : len(ids)] = ids
        return out
