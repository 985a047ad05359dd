"""Fixtures of the benchmark's tests: the small parts in ``data/`` shadow
the full-size ones by name, so a whole run fits on the CPU."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from portbench.registry import PKG, Registry, load_benchmark  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture
def small():
    """The registry with the small parts first."""
    return Registry([DATA, PKG])


@pytest.fixture
def bench():
    return load_benchmark()


@pytest.fixture
def bench_parked(bench):
    """BENCHMARK.json with the entries of ``data/parked.json``: cells whose
    parts are kept and tested but that the benchmark does not measure
    (PERF.md, Open questions, says why each is parked)."""
    with open(DATA / "parked.json") as f:
        parked = json.load(f)
    return {k: v + parked.get(k, []) if isinstance(v, list) else v
            for k, v in bench.items()}


@pytest.fixture
def card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"
