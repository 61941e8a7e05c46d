"""The program's own spans and counters in a traced run: the ``iris.``
ranges that ``iris_tts_tpu_torch`` opens while the profiler records, and
the counters it advances then (``iris_tts_tpu_torch/utils/prof.py``).

:func:`split_idle` splits the device's idle time by the span the host had
open. The idle intervals are the complement, over the traced stretch
(edges included), of the union of the device intervals, taken by
``devtrace.summarize``'s rule (kernels, copies and sets; not user
annotations, not ranges). The stretch is the ``trace_window_s`` that ends
where the last ``iris.job`` ends: the harness's clock stops as the last
traced job returns, and the profiler's own clock starts before the
harness's, at the profiler's start. Each idle interval is split by how
much of it lies under ``iris.frontend``, under ``iris.collect``, under the
rest of ``iris.job`` (encode, stage A, the bucket read, stage B and the
glue between them: dispatch), and outside ``iris.job`` (the caller's time
between jobs). A trace without ``iris.job`` (a program without the spans)
or without a device interval (off the card) gives None.

:func:`counters` reads the program's counters; None where the program has
none. Both are worked out once a run through the context's ``memo``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from perfbench.devtrace import PREFIX, _is_device

SPAN = "iris."
# The spans the split reads, by their short name.
SPLIT_SPANS = ("job", "frontend", "collect")


def _union(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _gaps(busy: List[List[float]], lo: float, hi: float):
    """The complement of the sorted, disjoint ``busy`` within [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append([t, min(s, hi)])
        t = max(t, e)
        if t >= hi:
            return out
    if t < hi:
        out.append([t, hi])
    return out


def _overlap(a: List[List[float]], b: List[List[float]]) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def split_idle(events, window_us: float) -> Optional[Dict[str, float]]:
    """Idle microseconds over the ``window_us`` that end with the last
    ``iris.job``: ``idle`` in all, and its parts ``frontend``,
    ``collect``, ``dispatch`` and ``outside``, which add up to it."""
    device, spans = [], {name: [] for name in SPLIT_SPANS}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if _is_device(e):
            if not (e.name.startswith((PREFIX, SPAN))
                    or getattr(e, "is_user_annotation", False)):
                device.append((start, end))
        elif e.name.startswith(SPAN) and e.name[len(SPAN):] in spans:
            spans[e.name[len(SPAN):]].append((start, end))
    if not device or not spans["job"]:
        return None
    end = max(e for _, e in spans["job"])
    idle = _gaps(_union(device), end - window_us, end)
    total = sum(e - s for s, e in idle)
    under = {name: _overlap(idle, _union(ivs))
             for name, ivs in spans.items()}
    return {"idle": total, "frontend": under["frontend"],
            "collect": under["collect"],
            "dispatch": under["job"] - under["frontend"] - under["collect"],
            "outside": total - under["job"]}


def idle_split(ctx) -> Optional[Dict[str, float]]:
    """:func:`split_idle` of the run's traced stretch."""

    def make():
        prof = ctx.record.get("profile")
        window_s = ctx.record.get("trace_window_s")
        if prof is None or not window_s:
            return None
        return split_idle(prof.events(), window_s * 1e6)

    return ctx.memo("idle_split", make)


def idle_pct(ctx, part: str) -> Optional[float]:
    """``part`` of the idle split, as a share of the traced stretch."""
    split = idle_split(ctx)
    if split is None:
        return None
    return 100.0 * split[part] / (ctx.record["trace_window_s"] * 1e6)


def counters(ctx) -> Optional[Dict[str, int]]:
    """The program's counters after the run (they advance only while the
    profiler records: in the benchmark, the traced jobs); None off a
    traced run or where the program keeps none."""

    def make():
        from iris_tts_tpu_torch.utils import prof

        read = getattr(prof, "counters", None)
        if ctx.record.get("profile") is None or read is None:
            return None
        return read()

    return ctx.memo("program_counters", make)
