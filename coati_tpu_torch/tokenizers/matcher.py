"""Leftmost-longest vocabulary matcher.

Splits text along the boundaries of known tokens, scanning left to right
and always taking the longest vocabulary token that starts at the current
position (the semantics of coati_tpu/tokenizers/matcher.py). This is the
pure-Python scan only: a first-char-indexed, length-descending search,
O(n * max_token_len). The native C fast path waits for a later slice.

Unmatched characters accumulate into passthrough spans (they later raise
KeyError at vocab lookup, as in the reference).
"""

from __future__ import annotations

from typing import Iterable, List


class VocabMatcher:
    """Pure-Python leftmost-longest scan over a fixed vocabulary."""

    def __init__(self, tokens: Iterable[str] = ()):
        # first char -> list of candidate tokens, longest first
        self._by_first: dict[str, List[str]] = {}
        self._max_len = 0
        for t in tokens:
            self.add(t)

    def add(self, token: str) -> None:
        if not token:
            return
        bucket = self._by_first.setdefault(token[0], [])
        if token not in bucket:
            bucket.append(token)
            bucket.sort(key=len, reverse=True)
            self._max_len = max(self._max_len, len(token))

    def _match_at(self, text: str, pos: int) -> str | None:
        bucket = self._by_first.get(text[pos])
        if not bucket:
            return None
        window = text[pos : pos + self._max_len]
        for cand in bucket:  # longest first
            if window.startswith(cand):
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
