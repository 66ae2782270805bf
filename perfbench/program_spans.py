"""What the readers of the program's own spans share.

The program (``repro_torch.core.telemetry.span``) opens a span at each
layer boundary of the store's hot path, recovery and the serving step
while a profiler runs, so in a traced window they lie in the trace beside
the benchmark's spans (``update_batch``, ``reads``, ``update``, ...) on one
clock.  A checkout whose program opens none of them has none in its trace:
each reader then returns None and its metric is left out.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import List, Optional, Sequence, Tuple

from perfbench.harness import median

Spans = Sequence[Tuple[int, int]]


def per_outer(outer: Spans, inner: Spans) -> List[Tuple[int, int]]:
    """For each span of ``outer`` (disjoint, as the benchmark's calls are):
    how many spans of ``inner`` start inside it and their total ns."""
    outer = sorted(outer)
    starts = [a for a, _b in outer]
    out = [[0, 0] for _ in outer]
    for a, b in inner:
        k = bisect_right(starts, a) - 1
        if k >= 0 and a < outer[k][1]:
            out[k][0] += 1
            out[k][1] += b - a
    return [(n, t) for n, t in out]


def spans(run, name: str) -> Optional[List[Tuple[int, int]]]:
    """The window's spans ``name``, or None without a trace or any such
    span."""
    if run.trace is None:
        return None
    return run.trace.spans(name) or None


def fused_stage_ms(run, stage: str) -> Optional[float]:
    """Median, over the benchmark's ``update_batch`` calls that the fused
    driver took (a ``fused.kernel`` span inside), of the ms inside the
    stage's spans."""
    calls, kernel = spans(run, "update_batch"), spans(run, "fused.kernel")
    inner = spans(run, stage)
    if not calls or not kernel or not inner:
        return None
    fused = [n for n, _t in per_outer(calls, kernel)]
    ms = [t / 1e6 for f, (_n, t) in zip(fused, per_outer(calls, inner)) if f]
    return median(ms)


def update_us(run, name: str) -> Optional[float]:
    """Mean us an update spends inside the spans ``name`` that open within
    the benchmark's ``update`` calls: their total over the updates."""
    calls, inner = spans(run, "update"), spans(run, name)
    n = run.counts.get("updates")
    if not calls or not inner or not n:
        return None
    return sum(t for _n, t in per_outer(calls, inner)) / 1e3 / n
