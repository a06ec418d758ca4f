"""The program's own spans as a traced run's profile holds them.

Each span of `coati_tpu_torch/common/tracing.py` opens a `coati.<name>`
range on the host timeline whenever a profiler is active, so a
`harness.Trace` of a traced run carries them among its host operations,
on the clock of the card's operations. The per-layer metrics that read
the program's spans take them from there; a program without those spans
leaves none, and the readers then return None."""

from __future__ import annotations

import bisect
from collections import defaultdict

from portbench.harness import NOT_KERNELS

PREFIX = "coati."
OUTSIDE = "(no span)"


def ranges(trace, name: str) -> list:
    """(start_s, end_s) of every range of the span `name`, by start."""
    full = PREFIX + name
    return [(s, e) for n, s, e in trace.host_ops if n == full]


def seconds(spans) -> float:
    return sum(e - s for s, e in spans)


def within(spans, outer) -> list:
    """The ranges of `spans` that lie inside one of `outer`."""
    starts = [s for s, _ in outer]
    out = []
    for s, e in spans:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            out.append((s, e))
    return out


def kernels_inside(trace, spans) -> int:
    """Kernel launches of the card whose start lies inside one of `spans`
    (ranges that do not overlap)."""
    starts = [s for s, _ in spans]
    n = 0
    for name, s, _ in trace.device_ops:
        if name.startswith(NOT_KERNELS):
            continue
        i = bisect.bisect_right(starts, s) - 1
        n += i >= 0 and s <= spans[i][1]
    return n


def _busy(device_ops):
    """The union of the card's operation intervals, in order."""
    merged = []
    for _, s, e in sorted(device_ops, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_inside(trace, spans) -> float:
    """Seconds of `spans` (ranges that do not overlap) in which the card
    ran nothing."""
    busy = _busy(trace.device_ops)
    idle = 0.0
    for s, e in spans:
        covered = sum(max(0.0, min(e, be) - max(s, bs)) for bs, be in busy
                      if be > s and bs < e)
        idle += (e - s) - covered
    return idle


def idle_by_span(trace) -> dict:
    """Idle seconds of the card between its operations, each gap under the
    innermost program span open on the host when the card went idle
    (OUTSIDE where none was)."""
    # by start, and an outer span before the inner one that starts with it
    spans = sorted(((s, e, n[len(PREFIX):]) for n, s, e in trace.host_ops
                    if n.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
    busy = _busy(trace.device_ops)
    out = defaultdict(float)
    stack, i = [], 0
    for (_, went_idle), (back, _) in zip(busy, busy[1:]):
        while i < len(spans) and spans[i][0] <= went_idle:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < went_idle:
            stack.pop()
        out[stack[-1][2] if stack else OUTSIDE] += back - went_idle
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def log_idle_by_span(r) -> None:
    """Put the traced stretch's idle seconds by innermost span into the
    run's log (standard error), once, where the trace holds the program's
    spans."""
    trace = r.get("trace")
    log = r.setdefault("log", {})
    if trace is None or "idle_by_span" in log:
        return
    if any(n.startswith(PREFIX) for n, _, _ in trace.host_ops):
        log["idle_by_span"] = idle_by_span(trace)


def fetches(trace) -> list:
    """The trainer's waits for a batch (`train.batch`) that the profile saw
    whole: a wait still open when the profile stopped returned no batch
    to copy (`train.to_device`) inside it, and is left out."""
    batch, copies = ranges(trace, "train.batch"), ranges(trace, "train.to_device")
    if batch and not any(s >= batch[-1][1] for s, _ in copies):
        batch = batch[:-1]
    return batch
