"""The NUTS sampler's spans and counters (``utils/metrics.py``):
``nuts.query``, ``nuts.transition``, ``nuts.transitions`` and
``nuts.leaves``, on the CPU's lockstep loop."""

from __future__ import annotations

import time

import pytest
import torch

import lhvi_tpu_torch as lt
from lhvi_tpu_torch.engines import nuts
from lhvi_tpu_torch.models.toy import gaussian_grid
from lhvi_tpu_torch.utils import metrics


@pytest.fixture
def fresh_tracing():
    """Tracing off and no records or counts, before and after."""
    metrics.enable_tracing(False)
    metrics.reset_tracing()
    yield
    metrics.enable_tracing(False)
    metrics.reset_tracing()


def _grid3():
    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    return lt.compile_graph(g, "cpu")


def _leaf_spy(monkeypatch):
    """Records the per-chain leaf counts of every transition (on the CPU
    each is one call of the lockstep loop)."""
    seen = []
    real = nuts._nuts_lockstep

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(out[2].clone())
        return out

    monkeypatch.setattr(nuts, "_nuts_lockstep", spy)
    return seen


@pytest.mark.parametrize("collect,thin,n_warmup", [
    ("moments", 1, 4), ("samples", 2, 4),
    ("moments", 1, 2 * nuts._LEAF_FOLD + 5)])  # folds past the batch
def test_counters_count_transitions_and_every_chains_leaves(
        fresh_tracing, monkeypatch, collect, thin, n_warmup):
    """``nuts.transitions`` counts n_warmup + thin × n_samples;
    ``nuts.leaves`` is the leaves every chain integrated, summed over the
    chains and every transition (warmup included, however many folds of
    ``_LEAF_FOLD`` transitions that takes); the moment stream keeps its own
    counter."""
    seen = _leaf_spy(monkeypatch)
    n_samples = 3
    nuts.run_nuts(_grid3(), torch.Generator().manual_seed(0),
                  nuts.NUTSConfig(max_depth=3), n_chains=6,
                  n_warmup=n_warmup, n_samples=n_samples, thin=thin,
                  collect=collect)
    n_trans = n_warmup + thin * n_samples
    got = metrics.counters()
    assert got["nuts.transitions"] == n_trans == len(seen)
    assert got["nuts.leaves"] == int(sum(int(s.sum()) for s in seen))
    assert all(s.shape == (6,) and int(s.min()) >= 1 and int(s.max()) <= 7
               for s in seen)
    assert got["hmc.draws"] == (n_samples if collect == "moments" else 0)
    assert got["hmc.transitions"] == 0


def test_lockstep_leaves_stop_with_each_chains_tree():
    """The lockstep loop counts a chain's leaves only until its tree
    stopped: a chain whose tree stopped at depth d integrated every leaf of
    the levels before its last and at least one of the last, so
    2^(d−1) ≤ n_leaf ≤ 2^d − 1, whatever the other chains did."""
    fg = _grid3()
    C, D = 256, 5
    gen = torch.Generator().manual_seed(3)
    xc = torch.randn((C, fg.n_cont), generator=gen)
    _, _, depth, div, n_leaf = nuts._nuts_sweep_batched(
        fg, gen, xc, None, torch.tensor(0.3), torch.ones(fg.n_cont), D)
    assert bool((n_leaf <= (1 << depth) - 1).all())
    assert bool((n_leaf >= (1 << (depth - 1))).all())  # every earlier level
    assert int(depth.min()) < int(depth.max())  # trees of several sizes
    assert not bool(div.any())


def test_spans_with_tracing_on(fresh_tracing):
    """With tracing on, the query is span ``nuts.query`` (a new query id)
    and each transition a ``nuts.transition`` inside it; the moment
    stream's ``hmc.moments`` sits inside the query too."""
    n_warmup, n_samples = 2, 3
    fg = _grid3()
    with metrics.tracing():
        for _ in range(2):
            nuts.run_nuts(fg, torch.Generator().manual_seed(0),
                          nuts.NUTSConfig(max_depth=2), n_chains=4,
                          n_warmup=n_warmup, n_samples=n_samples,
                          collect="moments")
    recs = metrics.spans()
    names = [s.name for s in recs]
    assert names.count("nuts.query") == 2
    assert names.count("nuts.transition") == 2 * (n_warmup + n_samples)
    assert names.count("hmc.moments") == 2 * n_samples
    tops = [i for i, s in enumerate(recs) if s.name == "nuts.query"]
    assert [recs[i].query for i in tops] == [0, 1]
    for s in recs:
        if s.name != "nuts.query":
            p = recs[s.parent]
            assert p.name == "nuts.query" and s.query == p.query
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns


def test_spans_off_are_one_flag_test(fresh_tracing, monkeypatch):
    """Off, every span of a NUTS query is the shared no-op context: no
    record and no clock read, while the counters count."""
    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert metrics.span("nuts.transition") is metrics.span(
        "nuts.query", new_query=True)
    nuts.run_nuts(_grid3(), torch.Generator().manual_seed(0),
                  nuts.NUTSConfig(max_depth=2), n_chains=4, n_warmup=2,
                  n_samples=2, collect="moments")
    assert metrics.spans() == []
    assert metrics.counters()["nuts.transitions"] == 4
