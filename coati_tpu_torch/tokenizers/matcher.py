"""Leftmost-longest vocabulary matcher.

Splits text along the boundaries of known tokens, scanning left to right
and always taking the longest vocabulary token that starts at the current
position (the semantics of coati_tpu/tokenizers/matcher.py). This is the
pure-Python scan only: per first character, the vocabulary's tokens grouped
by length, tried longest first with one set lookup each, so a position costs
the number of distinct token lengths and not the number of tokens (the "mar"
vocabulary has thousands that start with "["). The native C fast path waits
for a later slice.

Unmatched characters accumulate into passthrough spans (they later raise
KeyError at vocab lookup, as in the reference).
"""

from __future__ import annotations

from typing import Iterable, List


class VocabMatcher:
    """Pure-Python leftmost-longest scan over a fixed vocabulary."""

    def __init__(self, tokens: Iterable[str] = ()):
        # first char -> {length: tokens of that length}, and the lengths,
        # longest first
        self._by_first: dict[str, dict[int, set[str]]] = {}
        self._lengths: dict[str, List[int]] = {}
        for t in tokens:
            self.add(t)

    def add(self, token: str) -> None:
        if not token:
            return
        by_length = self._by_first.setdefault(token[0], {})
        by_length.setdefault(len(token), set()).add(token)
        self._lengths[token[0]] = sorted(by_length, reverse=True)

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
