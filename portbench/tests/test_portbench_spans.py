"""The program's spans laid over a device trace (``spans.py``), the six
readers of the split, and the split of a small query on the CPU and on
the card."""

from __future__ import annotations

import types

import pytest

from portbench import run, spans, trace
from portbench.registry import Registry


class Ev:
    """A kineto event: kind, name, start, duration, correlation id."""

    def __init__(self, kind, name, start, dur, corr=0):
        self.k, self.n, self.s, self.d, self.c = kind, name, start, dur, corr

    def activity_type(self):
        return self.k

    def name(self):
        return self.n

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.c


def read(name, c):
    return Registry().module("metrics", name).read(c)


# A query [0, 1000] with two transitions and a moment update between them;
# kernel 1 starts after the span that launched it has ended, kernel 4 is
# launched under the query alone, kernel 5 has no launch in the trace, and
# a host op shares kernel 1's correlation id without launching it.
EVENTS = [
    Ev("user_annotation", "hmc.query", 0, 1000),
    Ev("user_annotation", "hmc.transition", 100, 200),
    Ev("user_annotation", "hmc.moments", 400, 100),
    Ev("user_annotation", "hmc.transition", 600, 200),
    Ev("cuda_runtime", "cudaLaunchKernel", 150, 10, corr=1),
    Ev("cpu_op", "aten::add", 960, 10, corr=1),
    Ev("cuda_driver", "cuLaunchKernel", 450, 10, corr=2),
    Ev("cuda_runtime", "cudaLaunchKernel", 650, 10, corr=3),
    Ev("cuda_runtime", "cudaMemcpyAsync", 900, 10, corr=4),
    Ev("kernel", "k2", 320, 200, corr=1),
    Ev("kernel", "add", 450, 70, corr=2),
    Ev("kernel", "k2", 700, 200, corr=3),
    Ev("gpu_memcpy", "Memcpy DtoH", 950, 50, corr=4),
    Ev("kernel", "mul", 1100, 50, corr=5),
    Ev("gpu_user_annotation", "hmc.transition", 320, 200, corr=1),
]
WINDOW_S = 2000e-9


def test_timeline_names_the_innermost_span():
    line = spans.timeline([(0, 1000, "q"), (100, 300, "t"),
                           (150, 200, "u"), (600, 800, "t")])
    at = {t: spans.innermost(line, t)
          for t in (-5, 0, 120, 175, 250, 350, 700, 900, 1001)}
    assert at == {-5: "outside", 0: "q", 120: "t", 175: "u", 250: "t",
                  350: "q", 700: "t", 900: "q", 1001: "outside"}


def test_device_time_goes_to_the_span_of_its_launch():
    sp = spans.split(EVENTS, WINDOW_S)
    assert sp["n_spans"] == 4 and sp["n_device_ops"] == 5
    assert sp["n_unlaunched"] == 1
    assert sp["device_s"] == pytest.approx({
        "hmc.transition": 400e-9,  # kernel 1 (ran after its span) + 3
        "hmc.moments": 70e-9, "hmc.query": 50e-9, "outside": 50e-9})
    assert sp["device_ops"]["hmc.transition"] == [["k2", pytest.approx(
        400e-9)]]
    # busy [320, 520] + [700, 900] + [950, 1000] + [1100, 1150]: the gaps'
    # midpoints 610 (a transition), 925 (the query), 1050 (no span)
    assert sp["busy_s"] == pytest.approx(trace.summarize(
        EVENTS, WINDOW_S)["busy_s"]) == pytest.approx(500e-9)
    assert sp["idle_s"] == pytest.approx({
        "hmc.transition": 180e-9, "hmc.query": 50e-9, "outside": 100e-9})
    assert sp["edge_s"] == pytest.approx(WINDOW_S - 830e-9)


class EvNoKind(Ev):
    """An event of a torch whose kineto events carry no kind: a device, and
    the correlation id of the host operation it is linked to."""

    activity_type = property()

    def __init__(self, device, name, start, dur, corr=0, linked=0,
                 note=False):
        super().__init__(None, name, start, dur, corr)
        self.dev, self.linked, self.note = device, linked, note

    def device_type(self):
        return f"DeviceType.{self.dev}"

    def linked_correlation_id(self):
        return self.linked

    def is_user_annotation(self):
        return self.note


def test_launches_found_without_activity_kinds():
    """With no kinds, a launch is a host ``cu…`` call with the activity's
    correlation id (an aten op may share the number), and where none was
    recorded the start of the operation or annotation the activity is
    linked to stands for it; the device's copy of an annotation is no
    span and no activity."""
    events = [
        EvNoKind("CPU", "hmc.query", 0, 1000, corr=100, note=True),
        EvNoKind("CPU", "hmc.transition", 100, 200, corr=101, note=True),
        EvNoKind("CPU", "aten::add", 310, 20, corr=7),
        EvNoKind("CPU", "cudaLaunchKernel", 150, 10, corr=7, linked=3),
        EvNoKind("CUDA", "add", 400, 100, corr=7, linked=3),
        EvNoKind("CUDA", "k2", 500, 200, corr=8, linked=101),
        EvNoKind("CUDA", "mul", 800, 50, corr=9),
        EvNoKind("CUDA", "hmc.transition", 400, 300, corr=101, note=True),
    ]
    sp = spans.split(events, 1e-6)
    assert sp["n_spans"] == 2 and sp["n_device_ops"] == 3
    assert sp["n_unlaunched"] == 2
    assert sp["device_s"] == pytest.approx({"hmc.transition": 300e-9,
                                            "outside": 50e-9})
    assert sp["busy_s"] == pytest.approx(350e-9)


def test_idle_parts_sum_to_the_sample_idle():
    c = types.SimpleNamespace(trace=trace.summarize(EVENTS, WINDOW_S),
                              split=dict(spans.split(EVENTS, WINDOW_S),
                                         counts={}))
    loop, edges = read("device_idle.loop", c), read("device_idle.edges", c)
    assert loop == pytest.approx(9.0)
    assert edges == pytest.approx(66.0)
    assert loop + edges == pytest.approx(read("device_idle.sample", c))


def span_record(name, start, end):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end)


def test_the_six_readers_on_a_synthetic_ctx():
    sp = dict(spans.split(EVENTS, WINDOW_S),
              counts={"hmc.transitions": 2, "hmc.draws": 1})
    so = dict(host_s=spans.host_split(
        [span_record("hmc.query", 0, 9_000_000),
         span_record("hmc.transition", 0, 2_000_000),
         span_record("hmc.transition", 2_000_000, 3_000_000),
         span_record("hmc.moments", 3_000_000, 3_500_000)]),
        counts={"hmc.transitions": 2, "hmc.draws": 1})
    c = types.SimpleNamespace(split=sp, spans_only=so)
    assert read("device_ms.transition", c) == pytest.approx(200e-6)
    assert read("device_ms.moments", c) == pytest.approx(70e-6)
    assert read("host_ms.transition", c) == pytest.approx(1.5)
    assert read("host_ms.moments", c) == pytest.approx(0.5)
    names = ("device_ms.transition", "device_ms.moments",
             "host_ms.transition", "host_ms.moments", "device_idle.loop",
             "device_idle.edges")
    # a run without the program's spans (the harness's own context)
    bare = types.SimpleNamespace(queries=[], window_s=1.0, trace=None)
    assert all(read(n, bare) is None for n in names)
    # no device activity, no span, nothing counted
    empty = spans.split([Ev("cpu_op", "aten::add", 0, 10)], 1e-6)
    c = types.SimpleNamespace(split=dict(empty, counts={}),
                              spans_only=dict(host_s={}, counts={}))
    assert all(read(n, c) is None for n in names)


def test_phases_of_a_small_query_on_the_cpu(small):
    """The three phases of ``split.py`` on the small grid cell: the
    profiled phase's annotations and counts are the queries' own, and the
    spans-only phase times every transition and draw step on the host."""
    from lhvi_tpu_torch.utils import metrics as tracer

    from portbench import split

    cell = "grid128_hmc"
    cfg = small.json("configs", "gauss_grid128")
    mix = small.json("traffic", "hmc_c1024")
    kind = small.module("traffic", mix["kind"])
    ref = small.module("reference", "gauss_grid128")
    built = small.module("models", "gauss_grid128").build(
        cfg, ref.make_inputs(cfg, 7), "cpu")
    parts = split.phases(kind, built["fg"], mix, "cpu", 7, 1,
                         run.Reservoir(0, 7), tracer)
    n_t = mix["n_warmup"] + mix["n_samples"]
    want = {"hmc.transitions": n_t, "hmc.draws": mix["n_samples"]}
    assert parts["split"]["counts"] == want
    assert parts["split"]["n_spans"] == 1 + n_t + mix["n_samples"]
    assert parts["spans_only"]["counts"] == want
    c = types.SimpleNamespace(**parts, mix=mix, cfg=cfg,
                              cell=small.json("workloads", cell))
    assert read("host_ms.transition", c) > 0
    assert read("host_ms.moments", c) > 0
    assert read("device_ms.transition", c) is None  # no device activity
    assert not tracer.tracing_enabled() and tracer.spans() == []


@pytest.mark.cuda
def test_k2_time_is_the_transitions_on_the_card(card):
    """On the card, every launch of K2 (``dia_proposal_kernel``) is
    attributed to ``hmc.transition``, the moment update's kernels to
    ``hmc.moments``, and the split covers the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lhvi_tpu_torch as lt
    from lhvi_tpu_torch.engines import hmc
    from lhvi_tpu_torch.models.toy import gaussian_grid
    from lhvi_tpu_torch.utils import metrics as tracer

    g, _ = gaussian_grid(24, 24, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, card, quad_max_n=256)
    gen = torch.Generator(card).manual_seed(0)
    args = dict(n_chains=256, n_warmup=10, n_samples=10, collect="moments")
    hmc.run_hmc(fg, gen, hmc.HMCConfig(n_leapfrog=4), **args)  # builds
    torch.cuda.synchronize()
    tracer.reset_tracing()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with tracer.tracing():
        prof.start()
        hmc.run_hmc(fg, gen, hmc.HMCConfig(n_leapfrog=4), **args)
        torch.cuda.synchronize()
        prof.stop()
    assert tracer.counters()["ops.k2.launches"] == 20
    tracer.reset_tracing()
    sp = spans.split(prof.profiler.kineto_results.events(), 1.0, top=1000)
    k2 = {w: sum(v for n, v in ops if "dia_proposal" in n)
          for w, ops in sp["device_ops"].items()}
    assert k2["hmc.transition"] > 0
    assert all(v == 0 for w, v in k2.items() if w != "hmc.transition")
    assert sp["device_s"]["hmc.moments"] > 0
    assert sp["n_unlaunched"] == 0
    assert sum(sp["device_s"].values()) == pytest.approx(sp["busy_s"],
                                                         rel=0.01)
