"""The program's spans laid over the device trace of a profiled window.

With the program's tracer on (``lhvi_tpu_torch.utils.metrics.tracing()``)
under ``torch.profiler``, each span is a user annotation in the profiler's
events, on the clock of the device's activities. The split keeps:

- ``device_s``: device time by the innermost span enclosing each
  activity's *launch* (the ``cuda_runtime`` or ``cuda_driver`` event with
  the activity's correlation id), not its own start: the host runs ahead
  of the device. Where the events carry no kind (the card's torch 2.11), a
  launch is a host call named ``cu…``; where no launch was recorded, the
  start of the host operation the profiler linked the activity to
  (``linked_correlation_id``) stands for it. An activity launched under
  no span, or linked to nothing, counts as ``outside``;
- ``idle_s``: each gap between the merged busy intervals
  (``trace.union_length``), by the innermost span open on the host at the
  gap's midpoint (``outside`` where none is);
- ``edge_s``: the window's ends, from its start to the first device
  activity and from the last to its end (the host clock's window against
  the trace's first and last activity);
- ``device_ops``: device time by span and activity name, the largest few.

``host_split`` reads the in-memory span records of queries run with the
tracer on and the profiler off: host seconds by span name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

from portbench.trace import DEVICE_KINDS, NAME_CHARS, _kind, union_length

OUTSIDE = "outside"
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
LOOP = ("hmc.transition", "hmc.moments")


def timeline(spans: Iterable[Tuple[int, int, str]]):
    """(breakpoints, names): from ``breakpoints[i]`` on, the innermost open
    span of the nested ``(start, end, name)`` spans is ``names[i]``."""
    points: List[Tuple[int, str]] = []
    stack: List[Tuple[int, str]] = []

    def close_until(t):
        while stack and stack[-1][0] < t:
            end, _ = stack.pop()
            points.append((end, stack[-1][1] if stack else OUTSIDE))

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        stack.append((e, name))
        points.append((s, name))
    close_until(float("inf"))
    return [p[0] for p in points], [p[1] for p in points]


def innermost(line, t) -> str:
    """The innermost span open at ``t`` on a ``timeline``."""
    bounds, names = line
    i = bisect.bisect_right(bounds, t) - 1
    return names[i] if i >= 0 else OUTSIDE


def attribute_idle(merged: Sequence[Sequence[int]], line) -> dict:
    """Seconds of every gap between ``merged`` busy intervals, by the
    innermost span at the gap's midpoint."""
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        out[innermost(line, e0 + (s1 - e0) // 2)] += (s1 - e0) * 1e-9
    return dict(out)


def _linked(ev) -> int:
    """The correlation id of the host operation or annotation the profiler
    linked ``ev`` to (0: none, or ``ev`` is one of them)."""
    return int(getattr(ev, "linked_correlation_id", lambda: 0)())


def split(events, window_s: float, top: int = 6) -> dict:
    """Split the profiled window's device time and idle by span (see the
    module's docstring); ``events`` as ``trace.summarize`` takes them."""
    notes, launch_at, front_at, dev = [], {}, {}, []
    for ev in events:
        kind = _kind(ev)
        s = int(ev.start_ns())
        corr, linked = ev.correlation_id(), _linked(ev)
        if any(k in kind for k in DEVICE_KINDS) and "runtime" not in kind:
            dev.append((s, s + int(ev.duration_ns()), corr, linked,
                        ev.name()[:NAME_CHARS]))
        elif "cuda" in str(getattr(ev, "device_type", str)()).lower():
            continue  # the device's copies of the annotations
        elif kind == "user_annotation":
            notes.append((s, s + int(ev.duration_ns()), ev.name()))
            front_at[corr] = s
        elif kind in LAUNCH_KINDS or (
                not hasattr(ev, "activity_type") and kind == "cpu_op"
                and ev.name().startswith("cu")):
            launch_at[corr] = s
        elif not linked:
            front_at[corr] = s
    line = timeline(notes)
    device_s = defaultdict(float)
    by_op = defaultdict(lambda: defaultdict(float))
    n_unlaunched = 0
    for s, e, corr, linked, name in dev:
        t = launch_at.get(corr)
        if t is None:
            n_unlaunched += 1
            t = front_at.get(linked) if linked else None
        where = OUTSIDE if t is None else innermost(line, t)
        device_s[where] += (e - s) * 1e-9
        by_op[where][name] += (e - s) * 1e-9
    busy_ns, merged = union_length((s, e) for s, e, _, _, _ in dev)
    span_ns = merged[-1][1] - merged[0][0] if merged else 0
    return dict(
        device_s=dict(device_s), idle_s=attribute_idle(merged, line),
        edge_s=window_s - span_ns * 1e-9, busy_s=busy_ns * 1e-9,
        window_s=window_s, n_device_ops=len(dev), n_unlaunched=n_unlaunched,
        n_spans=len(notes),
        device_ops={w: [[k, v] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:top]]
            for w, ops in by_op.items()})


def loop_idle_pct(sp: dict):
    """Idle of the window whose innermost span is a transition or a
    moment update, in % of the window."""
    return 100.0 * sum(sp["idle_s"].get(n, 0.0) for n in LOOP) / sp[
        "window_s"]


def edges_idle_pct(sp: dict):
    """The rest of the window's idle (under the query's own span, under no
    span, and the window's ends), in % of the window."""
    rest = sum(v for n, v in sp["idle_s"].items() if n not in LOOP)
    return 100.0 * (rest + sp["edge_s"]) / sp["window_s"]


def host_split(records) -> dict:
    """Host seconds by span name of in-memory span records
    (``lhvi_tpu_torch.utils.metrics.spans()``)."""
    out = defaultdict(float)
    for r in records:
        out[r.name] += (r.end_ns - r.start_ns) * 1e-9
    return dict(out)
