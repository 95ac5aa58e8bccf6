"""The program's own profiler ranges in a traced run, for the readers of
``rt_bench/metrics/``: the ``rt.*`` spans and marks that the port's
wavefront loop (``ray_tracer_tpu_torch/integrator/wavefront.py``) records
while a profiler runs, and the device's idle gaps, each with its start.

A range's name is its kind and its counts, ``key=value`` words:
``rt.first_wave lanes=<n>``, ``rt.round lanes=<width> live=<live>``,
``rt.live_read``, and the zero-length mark ``rt.rays samples=<n> sem=<a>
traced=<b>``.  A program without them (before they were added) leaves
the trace with none, and every reader then returns None.
"""

from __future__ import annotations

import bisect

from .trace_view import union_us

PREFIX = "rt."


def parse(name: str):
    """``"rt.round lanes=8 live=5"`` -> ``("round", {"lanes": 8, "live":
    5})``; None for a name that is not the program's range."""
    if not name.startswith(PREFIX):
        return None
    kind, *words = name[len(PREFIX):].split()
    counts = {}
    for w in words:
        key, _, value = w.partition("=")
        if value:
            counts[key] = int(value)
    return kind, counts


def ranges(tv) -> list:
    """``(kind, counts, start, end)`` of each of the program's ranges
    among the window's host events, in the order of their starts."""
    out = []
    for name, a, b in tv.host:
        got = parse(name)
        if got is not None:
            out.append((got[0], got[1], a, b))
    return sorted(out, key=lambda r: r[2])


def of_kind(tv, *kinds) -> list:
    return [r for r in ranges(tv) if r[0] in kinds]


def readable(tv, idle: bool = False) -> bool:
    """Is there anything to read: profiled steps, the program's ranges
    and, for an idle reader (``idle``), device operations?"""
    return tv.steps > 0 and bool(ranges(tv)) and (not idle or bool(tv.device))


def gaps(tv) -> list:
    """``(start, end)`` of every stretch of the window with no device
    operation running: the window less the merged device intervals, as
    ``TraceView.idle_gaps`` takes them, in time order."""
    merged = []
    for _, a, b in sorted(tv.device, key=lambda e: e[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    edges = [tv.window[0]] + [x for m in merged for x in m] + [tv.window[1]]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_us_opening_in(tv, *kinds) -> float:
    """Microseconds of the idle gaps whose start falls inside a range of
    one of ``kinds``: what the host was doing when the device ran dry."""
    spans = [(a, b) for _, _, a, b in of_kind(tv, *kinds)]  # disjoint
    starts = [a for a, _ in spans]
    total = 0.0
    for s, e in gaps(tv):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < spans[i][1]:
            total += e - s
    return total


def host_us_in(tv, *kinds) -> float:
    """Microseconds of the host's timeline inside ranges of ``kinds``."""
    return union_us([(a, b) for _, _, a, b in of_kind(tv, *kinds)])
