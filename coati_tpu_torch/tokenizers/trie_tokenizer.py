"""SMILES + sentinel-token tokenizer.

Parity target: coati/models/encoding/tokenizers/trie_tokenizer.py
(TrieTokenizer :7, pre_tokenize :48, tokenize_text :61, batch_smiles :80,
decode :110-167). Behavior-identical, including FIM reordering and the
ints > 0 filter in decode; batch output is numpy (device-agnostic) rather
than a torch tensor.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from coati_tpu_torch.common.util import colored_background
from coati_tpu_torch.tokenizers.matcher import VocabMatcher


class TrieTokenizer:
    """Converts SMILES + sentinel tokens into integer ids and back."""

    def __init__(
        self,
        n_seq: int = 256,
        smiles_tokens: Sequence[str] = (),
        special_tokens: Sequence[str] = (),
        side_tasks: bool = True,
    ):
        self.n_seq = n_seq
        self.special_tokens = list(special_tokens)
        self.smiles_tokens = list(smiles_tokens)
        self.keys = self.special_tokens + self.smiles_tokens
        self.n_token = len(self.keys)
        self.vocab = {t.strip(): i for i, t in enumerate(self.keys)}

        self.stop_token = self.vocab["[STOP]"]
        self.pad_token = self.vocab["[PAD]"]
        self.clip_token = self.vocab["[CLIP]"]
        self.unk_token = self.vocab["[UNK]"]
        self.smiles_token = self.vocab["[SMILES]"]
        self.suffix_token = self.vocab["[SUFFIX]"]
        self.middle_token = self.vocab["[MIDDLE]"]
        if side_tasks:
            self.graph_token = self.vocab["[GRAPH]"]
            self.formula_token = self.vocab["[FORMULA]"]
            self.set_token = self.vocab["[SET]"]
        if "[MASK]" in self.vocab:  # COATI2 vocabs carry a [MASK] token
            self.mask_token = self.vocab["[MASK]"]

        self._special_set = set(self.special_tokens)
        self.special_matcher = VocabMatcher(self.special_tokens)
        self.smiles_matcher = VocabMatcher(self.smiles_tokens)
        # lazy caches for decode_batch
        self._keys_np: Optional[np.ndarray] = None
        self._special_lut: Optional[np.ndarray] = None

    # ----------------------------------------------------------------- encode
    def pre_tokenize(self, text: str) -> List[str]:
        """Split on special tokens first, then SMILES tokens."""
        out: List[str] = []
        for piece in self.special_matcher.split(text):
            if piece in self._special_set:
                out.append(piece)
            else:
                out.extend(self.smiles_matcher.split(piece))
        return out

    def tokenize_text(
        self, text: str, pad: bool = True, range_check: bool = True
    ) -> List[int]:
        try:
            ids = [self.vocab[t] for t in self.pre_tokenize(text)]
            if len(ids) > self.n_seq and range_check:
                raise ValueError(f"Oversized String ({len(ids)} > {self.n_seq})")
            if pad:
                ids = ids + [self.pad_token] * (self.n_seq - len(ids))
        except Exception as ex:
            print("tokenize text exception... ", text, ex, self.pre_tokenize(text))
            raise
        return ids

    def batch_smiles(
        self, smiles_batch: Sequence[str], skip_failed: bool = False
    ) -> Tuple[np.ndarray, List[int]]:
        """Tokenize '[SMILES]<s>[STOP]' rows into a (B, T) int32 array
        trimmed to the longest row; returns (tokens, bad_idxs)."""
        rows: List[List[int]] = []
        bad_idxs: List[int] = []
        for idx, smi in enumerate(smiles_batch):
            try:
                ids = self.tokenize_text(
                    "[SMILES]" + smi + "[STOP]", pad=False, range_check=False
                )
            except KeyError:
                if skip_failed:
                    ids = self.tokenize_text(
                        "[SMILES]C[STOP]", pad=False, range_check=False
                    )
                    bad_idxs.append(idx)
                else:
                    raise
            if len(ids) <= self.n_seq:
                rows.append(ids)
            else:
                bad_idxs.append(idx)
                rows.append(None)
        kept = [r for r in rows if r is not None]
        if not kept:
            return np.zeros((0, 0), dtype=np.int32), bad_idxs
        width = max(len(r) for r in kept)
        out = np.zeros((len(kept), width), dtype=np.int32)
        for i, r in enumerate(kept):
            out[i, : len(r)] = r
        return out, bad_idxs

    # ----------------------------------------------------------------- decode
    def decode(
        self,
        ints: Sequence[int],
        special: bool = True,
        end_at_stop: bool = True,
        de_fim: bool = True,
        color_loss: Optional[Sequence[float]] = None,
    ) -> str:
        """Detokenize a single row. Token id 0 ([PAD]) is dropped; with
        de_fim, [SUFFIX]/[MIDDLE] spans are re-ordered back to linear text."""
        ints = [int(i) for i in ints]
        if not ints:
            return ""
        if end_at_stop and self.stop_token in ints:
            ints = ints[: ints.index(self.stop_token) + 1]

        if color_loss is not None:
            assert len(color_loss) >= len(ints)
            lo, hi = min(color_loss), max(color_loss)
            scale = (hi - lo) or 1.0
            strings = [
                colored_background(
                    int((color_loss[i] - lo) / scale * 255), 128, 128, self.keys[t]
                )
                for i, t in enumerate(ints)
                if t > 0
            ]
        else:
            strings = [self.keys[t] for t in ints if t > 0]

        if de_fim and "[MIDDLE]" in strings and "[SUFFIX]" in strings:
            si = strings.index("[SUFFIX]")
            mi = strings.index("[MIDDLE]")
            strings = strings[:si] + strings[mi:-1] + strings[si:mi] + strings[-1:]
        if special:
            return "".join(strings)
        return "".join(s for s in strings if s not in self._special_set)

    def decode_batch(
        self,
        token_rows,
        special: bool = True,
        end_at_stop: bool = True,
        de_fim: bool = True,
    ) -> List[str]:
        """Vectorized detokenization of a (B, T) id array -> list of B
        strings, identical to per-row `decode`. The per-element Python
        of `decode` is a visible share of a batched round trip, so the
        lookups and masks run in numpy; rows containing FIM spans (rare in
        generation output) fall back to the scalar path for the
        reordering logic."""
        raw = np.asarray(token_rows)
        if raw.ndim != 2:
            raise ValueError(f"decode_batch expects (B, T), got {raw.shape}")
        if raw.size == 0:
            return ["" for _ in range(raw.shape[0])]
        if self._keys_np is None or len(self._keys_np) != self.n_token:
            self._keys_np = np.asarray(self.keys, dtype=object)
            lut = np.zeros(self.n_token, bool)
            lut[: len(self.special_tokens)] = True
            self._special_lut = lut
        b, t = raw.shape
        if raw.max() >= self.n_token:
            # match scalar decode, which indexes self.keys and raises —
            # silently clipping would decode corrupted ids as the last
            # vocab token and mask a wrong-tokenizer/model pairing
            bad = raw[raw >= self.n_token]
            raise IndexError(
                f"decode_batch: token id(s) out of range [0, {self.n_token}): "
                f"{np.unique(bad)[:8].tolist()}"
            )
        # negatives (e.g. the -1 label sentinel in y_next arrays) are
        # dropped exactly like [PAD]: scalar decode's `t > 0` filter
        toks = np.where(raw < 0, 0, raw)
        if end_at_stop:
            is_stop = toks == self.stop_token
            # row length INCLUDING the stop token (decode keeps it)
            length = np.where(is_stop.any(1), is_stop.argmax(1) + 1, t)
        else:
            length = np.full(b, t)
        keep = toks > 0
        if not special:
            keep &= ~self._special_lut[toks]
        fim = np.logical_and(
            (toks == self.suffix_token).any(1), (toks == self.middle_token).any(1)
        ) if de_fim else np.zeros(b, bool)
        strings = self._keys_np[toks]
        out = []
        for i in range(b):
            if fim[i]:
                out.append(
                    self.decode(
                        list(raw[i]),
                        special=special,
                        end_at_stop=end_at_stop,
                        de_fim=de_fim,
                    )
                )
            else:
                row_keep = keep[i, : length[i]]
                out.append("".join(strings[i, : length[i]][row_keep]))
        return out
