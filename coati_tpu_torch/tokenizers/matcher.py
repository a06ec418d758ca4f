"""Leftmost-longest vocabulary matcher.

Splits text along the boundaries of known tokens, scanning left to right
and always taking the longest vocabulary token that starts at the current
position (the semantics of coati_tpu/tokenizers/matcher.py). This is the
pure-Python scan only: per first character, the vocabulary's tokens grouped
by length, tried longest first with one set lookup each, so a position costs
the number of distinct token lengths and not the number of tokens (the "mar"
vocabulary has thousands that start with "["). As in coati_tpu, the split
runs in C (coati_tpu_torch/native/fast_matcher.c, a byte trie) when a C
compiler is present and the vocabulary is all ASCII (byte-level matching
cannot bisect multibyte characters); COATI_TPU_NO_NATIVE=1 keeps the
Python scan (`_split_python`). Both give the same split.

Unmatched characters accumulate into passthrough spans (they later raise
KeyError at vocab lookup, as in the reference).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, List


class VocabMatcher:
    """Leftmost-longest scan over a vocabulary, in C when it can be."""

    def __init__(self, tokens: Iterable[str] = ()):
        # first char -> {length: tokens of that length}, and the lengths,
        # longest first
        self._by_first: dict[str, dict[int, set[str]]] = {}
        self._lengths: dict[str, List[int]] = {}
        self._all_ascii = True
        self._native = None  # (lib, handle), built at the first split
        self._native_dead = os.environ.get("COATI_TPU_NO_NATIVE") == "1"
        for t in tokens:
            self.add(t)

    def add(self, token: str) -> None:
        if not token:
            return
        if not token.isascii():
            self._all_ascii = False
        if self._native is not None:  # keep an existing native trie in sync
            if token.isascii():
                lib, handle = self._native
                raw = token.encode()
                lib.matcher_add(handle, raw, len(raw))
            else:
                self._drop_native()
        by_length = self._by_first.setdefault(token[0], {})
        by_length.setdefault(len(token), set()).add(token)
        self._lengths[token[0]] = sorted(by_length, reverse=True)

    # ------------------------------------------------------------ native
    @property
    def uses_native(self) -> bool:
        """Whether splits of ASCII text run in C (builds the trie)."""
        return self._ensure_native() is not None

    def _drop_native(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            lib.matcher_free(handle)
            self._native = None
        self._native_dead = True

    def _ensure_native(self):
        if self._native is not None:
            return self._native
        if self._native_dead or not self._all_ascii:
            return None
        from coati_tpu_torch.native import load_fast_matcher

        lib = load_fast_matcher()
        if lib is None:
            self._native_dead = True
            return None
        handle = lib.matcher_new()
        for by_length in self._by_first.values():
            for tokens in by_length.values():
                for tok in tokens:
                    raw = tok.encode()
                    lib.matcher_add(handle, raw, len(raw))
        self._native = (lib, handle)
        return self._native

    def __del__(self):  # release the C trie
        try:
            if self._native is not None:
                self._native[0].matcher_free(self._native[1])
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_native"] = None  # rebuilt at the first split after unpickling
        return state

    def _split_native(self, text: str):
        native = self._ensure_native()
        if native is None:
            return None
        lib, handle = native
        raw = text.encode()
        n = len(raw)
        if n == 0:
            return []
        starts = (ctypes.c_int32 * n)()
        ends = (ctypes.c_int32 * n)()
        flags = (ctypes.c_uint8 * n)()
        count = lib.matcher_split(handle, raw, n, starts, ends, flags, n)
        return [raw[starts[i]: ends[i]].decode() for i in range(count)]

    def _match_at(self, text: str, pos: int) -> str | None:
        first = text[pos]
        lengths = self._lengths.get(first)
        if not lengths:
            return None
        by_length = self._by_first[first]
        for length in lengths:  # longest first
            cand = text[pos : pos + length]
            if cand in by_length[length]:
                return cand
        return None

    def split(self, text: str) -> List[str]:
        """Split text into [vocab tokens and passthrough spans], preserving
        all characters (''.join(result) == text)."""
        if text.isascii():
            native_out = self._split_native(text)
            if native_out is not None:
                return native_out
        return self._split_python(text)

    def _split_python(self, text: str) -> List[str]:
        out: List[str] = []
        span_start = 0  # start of current passthrough span
        pos = 0
        n = len(text)
        while pos < n:
            match = self._match_at(text, pos)
            if match is None:
                pos += 1
                continue
            if pos > span_start:
                out.append(text[span_start:pos])
            out.append(match)
            pos += len(match)
            span_start = pos
        if span_start < n:
            out.append(text[span_start:])
        return out


class Trie(VocabMatcher):
    """The reference's Trie class (coati/models/encoding/tokenizers/trie.py:
    add, split, cut_text), so code written against it runs unchanged; the
    matching is VocabMatcher's leftmost-longest scan (`split`)."""

    def cut_text(self, text: str, offsets: List[int]) -> List[str]:
        """`text` cut at the given offsets, zero-width pieces dropped."""
        offsets = list(offsets) + [len(text)]
        tokens: List[str] = []
        start = 0
        for end in offsets:
            if start > end:
                raise RuntimeError("cut_text offsets must be non-decreasing")
            if start == end:
                continue
            tokens.append(text[start:end])
            start = end
        return tokens
