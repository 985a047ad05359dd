"""The metric arithmetic on synthetic inputs."""

from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import roofline, trace
from portbench.registry import Registry


def ctx(**kw):
    base = dict(queries=[], window_s=1.0, setup_s=None, compile_s=None,
                trace=None, untraced=None, mix={}, cfg={}, cell={})
    return types.SimpleNamespace(**{**base, **kw})


def read(name, c):
    return Registry().module("metrics", name).read(c)


def test_rates_are_all_work_over_the_window():
    qs = [dict(wall_s=0.5, samples=1000, transitions=4),
          dict(wall_s=1.5, samples=1000, transitions=4)]
    assert read("samples_per_s", ctx(queries=qs, window_s=2.5)) == 800.0
    vs = [dict(wall_s=1.0, steps=200)] * 3
    assert read("vi_steps_per_s", ctx(queries=vs, window_s=4.0)) == 150.0
    assert read("samples_per_s", ctx(queries=vs)) is None


def test_p90_over_all_queries():
    qs = [dict(wall_s=float(w)) for w in range(1, 21)]  # 1..20 s
    assert read("query_s_p90", ctx(queries=qs)) == pytest.approx(18.1)
    assert read("query_s_p90", ctx(queries=qs[:9])) is None


class Ev:
    def __init__(self, kind, name, start, dur):
        self.k, self.n, self.s, self.d = kind, name, start, dur

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d


def test_idle_from_overlapping_intervals():
    events = [Ev("kernel", "a", 0, 100), Ev("kernel", "b", 50, 100),
              Ev("gpu_memcpy", "copy", 400, 100),
              Ev("kernel", "a", 900, 100),
              Ev("cpu_op", "aten::add", 140, 300),
              Ev("cuda_runtime", "cudaLaunchKernel", 600, 250)]
    s = trace.summarize(events, window_s=1e-6)
    # busy: [0,150] + [400,500] + [900,1000] = 350 ns of 1,000
    assert s["busy_s"] == pytest.approx(350e-9)
    assert s["n_kernels"] == 3
    for name in ("device_idle.sample", "device_idle.vi"):
        assert read(name, ctx(trace=s)) == pytest.approx(65.0)
    assert read("launches_per_transition", ctx(
        trace=s, queries=[dict(wall_s=1e-6, transitions=2)])) == 1.5
    gaps = dict((k, v) for k, v in trace.attribute_gaps(
        [[0, 150], [400, 500], [900, 1000]],
        [(140, 440, "aten::add"), (600, 850, "cudaLaunchKernel")],
        min_gap_ns=0).items())
    assert gaps == pytest.approx({"aten::add": 250e-9,
                                  "cudaLaunchKernel": 400e-9})


class EvNoKind(Ev):
    """An event of a torch whose kineto events carry no activity kind."""

    activity_type = property()

    def __init__(self, device, name, start, dur):
        super().__init__(None, name, start, dur)
        self.dev = device

    def device_type(self):
        return f"DeviceType.{self.dev}"


def test_kinds_without_kineto_activity_names():
    us = 1000
    events = [EvNoKind("CUDA", "k2", 0, 100 * us),
              EvNoKind("CUDA", "Memcpy DtoH (Device -> Pageable)", 200 * us,
                       50 * us),
              EvNoKind("CPU", "aten::add", 100 * us, 100 * us)]
    assert not hasattr(events[0], "activity_type")
    s = trace.summarize(events, window_s=1e-3)
    assert s["n_kernels"] == 1 and s["busy_s"] == pytest.approx(150e-6)
    assert s["idle_gaps"] == [["aten::add", pytest.approx(100e-6)]]


def test_no_device_trace_reads_nothing():
    s = trace.summarize([Ev("cpu_op", "aten::add", 0, 10)], window_s=1.0)
    c = ctx(trace=s, queries=[dict(wall_s=1.0, transitions=4, samples=8)],
            cfg=dict(n_latent=10, n_emb=16, dia_offsets=[-4, -1, 1, 4]),
            mix=dict(n_chains=2, hmc=dict(n_leapfrog=2)))
    for name in ("device_idle.sample", "device_idle.vi", "proposal_roofline",
                 "launches_per_transition", "step_mfu"):
        assert read(name, c) is None


def test_k2_bound_reproduces_the_smoke_scripts():
    """K2's bound at its bench shape: the 128x128 grid of seed 0 with 20%
    evidence, 1,024 chains, 8 steps: 0.0321 ms, bound by its bytes."""
    from lhvi_tpu_torch.models.toy import gaussian_grid

    g, _ = gaussian_grid(128, 128, seed=0, evidence_frac=0.2)
    n = sum(rv.value is None for rv in g.rvs)
    n_bytes, flops = roofline.proposal_work(1024, n, 16384, 4, 8)
    assert n_bytes / roofline.HBM_BYTES_PER_S > flops / roofline.F32_FLOPS_PER_S
    assert round(1e3 * roofline.bound_s(n_bytes, flops), 4) == 0.0321


def test_proposal_roofline_and_mfu_arithmetic():
    cfg = dict(n_latent=15600, n_emb=16384, dia_offsets=[-128, -1, 1, 128])
    mix = dict(n_chains=1024, hmc=dict(n_leapfrog=6), n_warmup=200,
               n_samples=200, stream_diag=True)
    least = roofline.bound_s(*roofline.proposal_work(1024, 15600, 16384, 4, 6))
    s = dict(busy_s=10 * 4 * least, window_s=1.0, n_kernels=100)
    c = ctx(trace=s, cfg=cfg, mix=mix,
            queries=[dict(wall_s=0.5, transitions=2)] * 2,
            untraced=dict(queries=[dict(wall_s=0.25)] * 2, seconds=0.5))
    assert read("proposal_roofline", c) == pytest.approx(10.0)
    products = 2 * 5 * 1024 * 16384 * 7
    updates = 1024 * 15600 * (2 * 7 + 3 * 6 + 10)
    draws = 1024 * 15600 * 12
    query = 400 * (products + updates) + 200 * draws
    assert read("step_mfu", c) == pytest.approx(
        100 * 2 * query / (0.5 * roofline.F32_FLOPS_PER_S))
    no_diag = dict(mix, stream_diag=False)
    assert roofline.query_flops(1024, 15600, 16384, 4, 6, 200, 200, False) \
        == query - 200 * 1024 * 15600 * 9
    assert read("step_mfu", ctx(cfg=cfg, mix=no_diag, trace=s)) is None


def test_union_length():
    total, merged = trace.union_length([(5, 7), (0, 3), (2, 4), (7, 9)])
    assert total == 8 and merged == [[0, 4], [5, 9]]
    assert trace.union_length([])[0] == 0
    assert np.isclose(trace.top({"a": 1.0, "b": 3.0}, 1)[0][1], 3.0)
