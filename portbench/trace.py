"""Reading a torch.profiler trace of the measured window.

From the device's events (kernels, copies, sets): the seconds in which an
operation ran (the union of their intervals), the operations that took the
most time, and the idle gaps between them, each named by the innermost host
range or op running at the gap's midpoint ("portbench.call": host Python
inside the index API, outside any torch op). The scan kernels are
counted by name, to hold the profiler against the program's launch counter.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Iterable, List, Tuple

#: the flat scan's kernels (K1/K2 in every design) as the profiler names them
SCAN_KERNELS = (
    "scan_wgmma_kernel", "scan_fma_kernel", "scan_mma_kernel",
    "bin_candidates_kernel", "count_below_kernel",
)

TOP = 10


def _is_device(evt) -> bool:
    """A kernel, copy or set on the device (not a host range projected onto
    the device's timeline)."""
    return "cuda" in str(evt.device_type).lower() and not getattr(evt, "is_user_annotation", False)


def _short(name: str) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = name.removeprefix("void ")
    for stop in ("<", "("):
        i = name.find(stop)
        if i > 0:
            name = name[:i]
    return name[:120]


def union_seconds(spans: Iterable[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(seconds covered by the spans [start_us, end_us], the gaps between
    their merged intervals)."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy * 1e-6, gaps


def summarize(events) -> dict:
    """busy_s, scan kernel count, and the breakdown's two lists from a
    profiler's events (FunctionEvent-like: name, device_type, time_range)."""
    dev, host = [], []
    for evt in events:
        span = (float(evt.time_range.start), float(evt.time_range.end))
        if _is_device(evt):
            dev.append((span, evt.name))
        elif "cpu" in str(evt.device_type).lower():
            host.append((span, evt.name))
    busy_s, gaps = union_seconds(s for s, _ in dev)
    by_op = defaultdict(float)
    scans = 0
    for (s, e), name in dev:
        by_op[_short(name)] += (e - s) * 1e-6
        scans += any(k in name for k in SCAN_KERNELS)
    # stab each gap's midpoint: the latest-started host event still running
    # there is the innermost one (events nest by start within a thread)
    host.sort()
    by_gap = defaultdict(float)
    running, j = [], 0
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0][0] <= mid:
            (s, e), n = host[j]
            heapq.heappush(running, (-s, e, n))
            j += 1
        while running and running[0][1] < mid:
            heapq.heappop(running)
        by_gap[running[0][2] if running else "idle (no host event)"] += (g1 - g0) * 1e-6
    return {
        "busy_s": busy_s,
        "scan_kernels": scans,
        "device_ops": sorted(([n, t] for n, t in by_op.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([n, t] for n, t in by_gap.items()), key=lambda x: -x[1])[:TOP],
    }
