"""Structured metrics logging (PyTorch port of ``lhvi_tpu/utils/metrics.py``).

Every engine or experiment can emit typed records (ELBO, acceptance rate,
ESS, R̂, throughput) to a JSONL file and/or stdout in the reference's
record format, and wrap hot sections in a ``torch.profiler`` trace that
Perfetto or ``chrome://tracing`` opens.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


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
    activity is traced too where a card is present. A no-op when
    ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
