"""The device trace of a traced window, reduced to what the metrics read.

``torch.profiler`` (CUPTI) records every device activity (kernels, copies,
fills) and every host operation. The reduction keeps:

- ``busy_s``: the length of the union of the device activities' intervals
  (overlapping activities on several streams count once);
- ``n_kernels``: device kernels launched (copies and fills not counted);
- ``device_ops``: device time by activity name, the ten largest;
- ``idle_gaps``: the gaps between device activities, summed by the
  innermost host operation running at each gap's midpoint (``python``
  where none runs: the interpreter between operations), the ten largest.

Names are cut to ``NAME_CHARS`` characters (kernels' template arguments
run to thousands).
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

DEVICE_KINDS = ("kernel", "memcpy", "memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver")
NAME_CHARS = 160


def _kind(ev) -> str:
    """The event's activity kind: kineto's name for it where the event
    carries one, else from its device and name ("kernel", "gpu_memcpy",
    "gpu_memset" on the device, "cpu_op" on the host)."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).lower()
    if getattr(ev, "is_user_annotation", lambda: False)():
        return "user_annotation"
    if "cuda" in str(ev.device_type()).lower():
        name = ev.name().lower()
        return ("gpu_memcpy" if name.startswith("memcpy") else
                "gpu_memset" if name.startswith("memset") else "kernel")
    return "cpu_op"


def union_length(intervals: Iterable[Tuple[int, int]]) -> Tuple[int, list]:
    """(total length, merged intervals) of possibly overlapping
    ``(start, end)`` intervals."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def top(totals: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(totals.items(),
                                      key=lambda kv: -kv[1])[:n]]


def attribute_gaps(merged: Sequence[Sequence[int]],
                   host: Sequence[Tuple[int, int, str]],
                   min_gap_ns: int = 2_000, max_scan: int = 4_000) -> dict:
    """Seconds of device idle between ``merged`` busy intervals, summed by
    the innermost host operation (``(start, end, name)``) covering each
    gap's midpoint (``python`` where none does: the interpreter between ops)."""
    host = sorted(host)
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gap = s1 - e0
        if gap < min_gap_ns:
            continue
        mid = e0 + gap // 2
        name = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - max_scan, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += gap * 1e-9
    return out


def summarize(events, window_s: float) -> dict:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``)
    of a window of ``window_s`` host seconds."""
    dev, host = [], []
    n_kernels = 0
    by_name = defaultdict(float)
    for ev in events:
        kind = _kind(ev)
        s = int(ev.start_ns())
        d = int(ev.duration_ns())
        if any(k in kind for k in DEVICE_KINDS) and "runtime" not in kind:
            dev.append((s, s + d))
            by_name[ev.name()[:NAME_CHARS]] += d * 1e-9
            n_kernels += "kernel" in kind
        elif any(k in kind for k in HOST_KINDS):
            host.append((s, s + d, ev.name()[:NAME_CHARS]))
    busy_ns, merged = union_length(dev)
    return dict(busy_s=busy_ns * 1e-9, window_s=window_s,
                n_kernels=n_kernels, n_device_ops=len(dev),
                device_ops=top(by_name),
                idle_gaps=top(attribute_gaps(merged, host)))


def idle_pct(summary) -> float:
    """The share of the traced window in which no device activity ran, in
    %; None without a trace or with no device activity in it."""
    if summary is None or not summary["busy_s"]:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
