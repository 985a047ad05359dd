"""Structured metrics logging (PyTorch port of ``lhvi_tpu/utils/metrics.py``).

Every engine or experiment can emit typed records (ELBO, acceptance rate,
ESS, R̂, throughput) to a JSONL file and/or stdout in the reference's
record format, and wrap hot sections in a ``torch.profiler`` trace that
Perfetto or ``chrome://tracing`` opens.

Spans and counters, the program's view of its own layers:

- ``count(name, n)`` adds to a named integer counter, always (the kernel
  launches ``ops.k1.launches`` … ``ops.k8.launches``, the samplers'
  ``hmc.transitions``, ``hmc.draws``, ``nuts.transitions`` and
  ``nuts.leaves``); ``counters()`` copies them.
- ``span(name)`` times a block on the host clock (``perf_counter_ns``)
  while tracing is on (``enable_tracing`` or the ``tracing()`` context,
  the module-flag pattern of ``utils/debug.py``). A record holds the
  name, start and end, the index of the enclosing span (-1 at the top)
  and the id of its query: a span opened with ``new_query=True`` starts
  a new id, and the spans inside it share it. Records stay in memory
  until ``spans()`` reads them or ``reset_tracing()`` clears them.
  While a ``torch.profiler`` is active each span also opens
  ``torch.profiler.record_function(name)``, so it appears in the
  profiler's trace as a user annotation on the clock of the device's
  kernels (``profile_trace`` shows it in Perfetto).

With tracing off a span is one test of a module flag that returns a shared
``nullcontext``: no clock is read and nothing is allocated.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import Counter
from typing import Any, Dict, List, NamedTuple, Optional

import torch


def _plain(v):
    """A JSON-ready value: one-element tensors and arrays become Python
    scalars (``.item()``), others lists (``.tolist()``), as the
    reference's record."""
    if hasattr(v, "numel") and hasattr(v, "tolist"):  # a torch tensor
        return v.item() if v.numel() == 1 else v.tolist()
    if hasattr(v, "item") and getattr(v, "size", 2) == 1:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        self.t0 = time.time()

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"t": round(time.time() - self.t0, 4), "event": event}
        for k, v in fields.items():
            rec[k] = _plain(v)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line)
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace around a block, written into ``log_dir`` as
    a Chrome/Perfetto trace (``trace_<pid>_<time>.json``); the CUDA
    activity is traced too where a card is present; with tracing on
    (``tracing()``) the program's spans appear in it as user annotations.
    A no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


# ---- spans and counters ---------------------------------------------------

_TRACING = False
_OFF = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}
_RECORDS: List[list] = []  # [name, start_ns, end_ns, parent, query]
_OPEN: List[int] = []  # indices of the open spans, innermost last
_QUERIES = 0  # query ids handed out since the last reset


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int  # -1 while the span is open
    parent: int  # index of the enclosing span in ``spans()``; -1 at the top
    query: int  # id of the enclosing query; -1 outside every query


def tracing_enabled() -> bool:
    return _TRACING


def enable_tracing(enable: bool = True) -> None:
    """Record spans (``span``); counters count whether or not."""
    global _TRACING
    _TRACING = bool(enable)


@contextlib.contextmanager
def tracing():
    """Context-managed version of :func:`enable_tracing`."""
    prev = _TRACING
    enable_tracing(True)
    try:
        yield
    finally:
        enable_tracing(prev)


def count(name: str, n: int = 1) -> None:
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counters() -> Counter:
    """A copy of the counts (a name never counted reads 0)."""
    return Counter(_COUNTS)


def spans() -> List[Span]:
    return [Span(*r) for r in _RECORDS]


def reset_tracing() -> None:
    """Drop the span records and zero the counters."""
    global _QUERIES
    if _OPEN:
        raise RuntimeError(f"reset_tracing inside {len(_OPEN)} open span(s)")
    _RECORDS.clear()
    _COUNTS.clear()
    _QUERIES = 0


class _Span:
    __slots__ = ("name", "new_query", "idx", "annotation")

    def __init__(self, name: str, new_query: bool):
        self.name, self.new_query = name, new_query

    def __enter__(self):
        global _QUERIES
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        parent = _OPEN[-1] if _OPEN else -1
        if self.new_query:
            query, _QUERIES = _QUERIES, _QUERIES + 1
        else:
            query = _RECORDS[parent][4] if parent >= 0 else -1
        self.idx = len(_RECORDS)
        _RECORDS.append([self.name, time.perf_counter_ns(), -1, parent,
                         query])
        _OPEN.append(self.idx)
        return self

    def __exit__(self, *exc):
        _RECORDS[self.idx][2] = time.perf_counter_ns()
        _OPEN.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        return False


def span(name: str, new_query: bool = False):
    """A context manager timing its block as span ``name`` while tracing
    is on (``new_query``: the block is one query and opens a new query
    id); the shared no-op context while it is off."""
    if not _TRACING:
        return _OFF
    return _Span(name, new_query)
