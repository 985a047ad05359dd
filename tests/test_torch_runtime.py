"""The port's runtime utilities held to the JAX reference: sampler
diagnostics (``utils/diagnostics.py``), the experiment configs
(``config.py``), the metrics logger, the profiler trace and the spans and
counters (``utils/metrics.py``), checkpoints (``utils/checkpoint.py``), the NaN
checks (``utils/debug.py``), the chain-sharding helpers that need no
process group (``parallel/mesh.py``) and the public surface.

The diagnostics get the same seeded numpy ``[S, C, n]`` inputs in both
packages and agree to f32 rounding (rtol 1e-5).
"""

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.config as ref_config  # noqa: E402
import lhvi_tpu.utils as ref_utils  # noqa: E402
from lhvi_tpu.utils import diagnostics as ref_diag  # noqa: E402
from lhvi_tpu.utils.metrics import MetricsLogger as RefLogger  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.config as config  # noqa: E402
import lhvi_tpu_torch.utils as utils  # noqa: E402
from lhvi_tpu_torch.engines import hmc  # noqa: E402
from lhvi_tpu_torch.models.toy import gaussian_grid, hybrid_chain  # noqa: E402
from lhvi_tpu_torch.parallel import ChainShard, local_count, split_generator  # noqa: E402
from lhvi_tpu_torch.utils import debug, diagnostics, metrics  # noqa: E402
from lhvi_tpu_torch.utils.checkpoint import CheckpointManager  # noqa: E402
from lhvi_tpu_torch.utils.metrics import MetricsLogger, profile_trace  # noqa: E402


def _draws(kind: str, S=400, C=4, n=3, seed=0):
    """Seeded [S, C, n] f32 draws: iid normals, AR(1) chains (φ = 0.9), or
    chains stuck at different offsets (not converged)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((S, C, n))
    if kind == "ar1":
        x = np.zeros_like(z)
        x[0] = z[0]
        for t in range(1, S):
            x[t] = 0.9 * x[t - 1] + np.sqrt(1 - 0.81) * z[t]
        z = x
    elif kind == "stuck":
        z = 0.3 * z + np.arange(C)[None, :, None] * 1.5
    return z.astype(np.float32)


@pytest.mark.parametrize("kind", ["iid", "ar1", "stuck"])
def test_diagnostics_match_reference(kind):
    """split_rhat, ess (Geyer's pair truncation) and summarize against
    lhvi_tpu.utils.diagnostics on the same draws."""
    x = _draws(kind)
    got = diagnostics.summarize(torch.from_numpy(x))
    want = ref_diag.summarize(jnp.asarray(x))
    for k in ("rhat", "ess", "mean", "sd"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(
        diagnostics.ess(torch.from_numpy(x), max_lag=7).numpy(),
        np.asarray(ref_diag.ess(jnp.asarray(x), max_lag=7)), rtol=1e-5)
    if kind == "stuck":
        assert float(got["rhat"].min()) > 1.5
    if kind == "iid":
        assert np.abs(got["rhat"].numpy() - 1.0).max() < 0.02


def test_streamed_rhat_equals_split_rhat_on_samples():
    """lhvi_tpu/engines/hmc.py:402's claim in the port: the streamed R̂ of a
    moments run is split-R̂ of the same draws materialized (one generator
    seed gives the same chains in both modes)."""
    g, _ = gaussian_grid(3, 3, seed=1, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    kw = dict(n_chains=8, n_warmup=20, n_samples=60)
    s_xc, _, _ = hmc.run_hmc(fg, torch.Generator().manual_seed(3), **kw)
    _, _, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(3),
                             collect="moments", **kw)
    np.testing.assert_allclose(diag["rhat"].numpy(),
                               utils.split_rhat(s_xc).numpy(), rtol=1e-4)


def test_config_matches_reference():
    """Every config class has the reference's fields and defaults, and
    add_args/from_args round-trip a command line."""
    classes = ["EngineConfig", "ChainConfig", "GridConfig",
               "FriendsSmokersConfig", "LDSConfig", "RobotMapConfig",
               "PodConfig"]
    for name in classes:
        ours, ref = getattr(config, name), getattr(ref_config, name)
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
    p = argparse.ArgumentParser()
    config.add_args(p, config.GridConfig())
    args = p.parse_args(["--engine", "hmc", "--rows", "6", "--lifted", "true",
                         "--evidence-frac", "0.5", "--metrics-path", "m.jsonl"])
    cfg = config.from_args(config.GridConfig, args)
    assert cfg == dataclasses.replace(config.GridConfig(), engine="hmc",
                                      rows=6, lifted=True, evidence_frac=0.5,
                                      metrics_path="m.jsonl")
    q = argparse.ArgumentParser()
    ref_config.add_args(q, ref_config.GridConfig())
    assert vars(q.parse_args([])) == vars(p.parse_args([]))


def test_metrics_logger_writes_reference_records(tmp_path):
    """The same fields give the same JSONL record as the reference's
    (apart from the clock): tensors and arrays of one element become
    scalars, others lists."""
    fields = dict(engine="hmc", budget=50, err=0.125, flag=True, nothing=None,
                  vec=np.arange(3, dtype=np.float32),
                  one=np.ones(1, np.float32), scalar=np.float32(2.5))
    ours = dict(fields, t0=torch.tensor(1.5), t1=torch.tensor([1.0, 2.0]),
                t2=torch.ones(1, 2))
    refs = dict(fields, t0=jnp.asarray(1.5), t1=jnp.asarray([1.0, 2.0]),
                t2=jnp.ones((1, 2)))
    with MetricsLogger(str(tmp_path / "a" / "m.jsonl")) as a, \
            RefLogger(str(tmp_path / "b" / "m.jsonl")) as b:
        a.log("point", **ours)
        b.log("point", **refs)
    la = json.loads((tmp_path / "a" / "m.jsonl").read_text())
    lb = json.loads((tmp_path / "b" / "m.jsonl").read_text())
    la.pop("t"), lb.pop("t")
    assert la == lb
    assert la["t0"] == 1.5 and la["t1"] == [1.0, 2.0]


def test_profile_trace_writes_a_trace(tmp_path):
    with profile_trace(None):
        torch.ones(4).sum()
    with profile_trace(str(tmp_path / "tr")):
        torch.ones(4).sum()
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.loads((tmp_path / "tr" / files[0]).read_text())


@pytest.fixture
def fresh_tracing():
    """Tracing off and no records or counts, before and after."""
    metrics.enable_tracing(False)
    metrics.reset_tracing()
    yield
    metrics.enable_tracing(False)
    metrics.reset_tracing()


def test_spans_nest_with_parent_and_query(fresh_tracing):
    """A span records its enclosing span's index and its query's id; a
    ``new_query`` span opens the next id, and the spans inside share it."""
    with metrics.tracing():
        assert metrics.tracing_enabled()
        with metrics.span("loose"):
            pass
        for _ in range(2):
            with metrics.span("q", new_query=True):
                with metrics.span("a"):
                    with metrics.span("b"):
                        metrics.count("n", 2)
                with metrics.span("a"):
                    pass
    assert not metrics.tracing_enabled()
    got = [(s.name, s.parent, s.query) for s in metrics.spans()]
    assert got == [("loose", -1, -1),
                   ("q", -1, 0), ("a", 1, 0), ("b", 2, 0), ("a", 1, 0),
                   ("q", -1, 1), ("a", 5, 1), ("b", 6, 1), ("a", 5, 1)]
    for s in metrics.spans():
        assert 0 < s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = metrics.spans()[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert metrics.counters() == {"n": 4} and metrics.counters()["m"] == 0
    metrics.reset_tracing()
    assert metrics.spans() == [] and metrics.counters() == {}


def test_tracing_off_records_nothing_and_reads_no_clock(fresh_tracing,
                                                        monkeypatch):
    """Off, a span is the shared no-op context: a whole query records no
    span and reads no clock, while the counters still count."""
    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert metrics.span("x") is metrics.span("y", new_query=True)
    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    hmc.run_hmc(fg, torch.Generator().manual_seed(0),
                hmc.HMCConfig(n_leapfrog=2), n_chains=4, n_warmup=2,
                n_samples=3, collect="moments")
    assert metrics.spans() == []
    assert metrics.counters() == {"hmc.transitions": 5, "hmc.draws": 3}


def test_run_hmc_spans_under_the_profiler(fresh_tracing):
    """A moments query with tracing on and ``torch.profiler`` running:
    every transition and every draw step is a user annotation of the
    profiler's trace, all inside the query's, and the in-memory spans and
    the counters agree with them."""
    from torch.profiler import ProfilerActivity, profile

    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    n_warmup, n_samples = 3, 4
    with metrics.tracing(), profile(activities=[ProfilerActivity.CPU]) as p:
        hmc.run_hmc(fg, torch.Generator().manual_seed(0),
                    hmc.HMCConfig(n_leapfrog=2), n_chains=4,
                    n_warmup=n_warmup, n_samples=n_samples,
                    collect="moments")
    notes = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in p.profiler.kineto_results.events()
             if e.activity_type() == "user_annotation"]
    by_name = {n: [(s, e) for m, s, e in notes if m == n]
               for n in ("hmc.query", "hmc.transition", "hmc.moments")}
    assert len(notes) == 1 + n_warmup + 2 * n_samples
    assert len(by_name["hmc.transition"]) == n_warmup + n_samples
    assert len(by_name["hmc.moments"]) == n_samples
    (q0, q1), = by_name["hmc.query"]
    assert all(q0 <= s <= e <= q1 for _, s, e in notes)
    recs = metrics.spans()
    assert [s.name for s in recs].count("hmc.transition") == (n_warmup
                                                             + n_samples)
    assert all(s.query == 0 and s.parent == (-1 if s.name == "hmc.query"
                                             else 0) for s in recs)
    assert metrics.counters() == {"hmc.transitions": n_warmup + n_samples,
                                  "hmc.draws": n_samples}


def test_checkpoint_manager_round_trip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in range(4):
        mgr.save(step, {"x": torch.full((3,), float(step)), "n": step,
                        "nest": {"y": torch.arange(step + 1)}}, wait=True)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore()
    assert back["n"] == 3 and torch.equal(back["x"], torch.full((3,), 3.0))
    assert torch.equal(mgr.restore(2)["nest"]["y"], torch.arange(3))
    mgr.close()
    # a fresh manager on the same directory sees the same steps
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 3


def test_checkpoint_manager_writes_atomically(tmp_path, monkeypatch):
    """A save killed mid-write leaves no step that latest_step picks up:
    the payload goes to a temporary name first."""
    d = tmp_path / "ck"
    mgr = CheckpointManager(str(d), max_to_keep=3)
    mgr.save(0, {"x": torch.zeros(2)})
    (d / "step_7.pt.tmp-999").write_bytes(b"partial")

    def killed(obj, fh):
        fh.write(b"partial")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(5, {"x": torch.ones(2)})
    monkeypatch.undo()
    assert mgr.latest_step() == 0
    assert torch.equal(mgr.restore()["x"], torch.zeros(2))


def test_nan_checks_trap_a_transition():
    """With the checks on, a transition that makes a NaN raises: the
    forward check names the tensor (the quadratic proposal has no
    backward), and anomaly detection traps autograd's backward on the
    non-quadratic one. Off, the same transitions run."""
    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    g2, _ = hybrid_chain()
    fg2 = lt.compile_graph(g2, "cpu")
    cfg = hmc.HMCConfig()
    gen = torch.Generator().manual_seed(1)
    states = []
    for f in (fg, fg2):
        state = hmc.init_hmc_state(f, torch.Generator().manual_seed(0), cfg, 4)
        bad = state._replace(xc=torch.full_like(state.xc, float("nan")))
        hmc.hmc_transition(f, cfg, bad, gen, False)
        states.append((state, bad))
    assert not debug.nan_checks_enabled()
    with utils.nan_checks():
        assert debug.nan_checks_enabled() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="NaN in xc"):
            hmc.hmc_transition(fg, cfg, states[0][1], gen, False)
        with pytest.raises(RuntimeError, match="nan"):
            hmc.hmc_transition(fg2, cfg, states[1][1], gen, False)
        hmc.hmc_transition(fg, cfg, states[0][0], gen, True)
    assert not debug.nan_checks_enabled()
    assert not torch.is_anomaly_enabled()


def test_public_surface_matches_reference():
    assert sorted(utils.__all__) == sorted(ref_utils.__all__)
    assert "compile_lifted" in lt.__all__
    assert lt.compile_lifted is lt.lift.compile_lifted
    g, _ = hybrid_chain()
    fg = lt.compile_lifted(g, "cpu")
    assert fg.n_cont == 2 and fg.n_disc == 1


def test_shard_helpers_without_a_process_group():
    """n_chain_shards is the one divisibility authority (a count that does
    not divide raises); split_generator derives distinct rank streams and
    one shared stream, the same on every rank."""
    assert local_count(12, None) == 12
    assert local_count(12, ChainShard(1, 3)) == 4
    assert ChainShard(2, 3).rows(12) == (8, 12)
    with pytest.raises(ValueError, match="do not divide"):
        local_count(10, ChainShard(0, 4))
    seeds = []
    for rank in range(3):
        r, s = split_generator(torch.Generator().manual_seed(5), rank)
        seeds.append((r.initial_seed(), s.initial_seed()))
    assert len({r for r, _ in seeds}) == 3
    assert len({s for _, s in seeds}) == 1
    assert seeds[0][0] != seeds[0][1]
    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    with pytest.raises(ValueError, match="15 chains do not divide over 2"):
        hmc.run_hmc(fg, torch.Generator(), n_chains=15, n_warmup=0,
                    n_samples=1, shard=ChainShard(0, 2))


def test_nan_checks_trap_a_vi_step():
    """The VI optimizer step is checked too: a NaN initial mean makes the
    ELBO NaN, which raises with the checks on and runs without them."""
    from lhvi_tpu_torch.engines import vi

    g, _ = gaussian_grid(3, 3, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    cfg = vi.VIConfig(K=2, n_iters=2)
    params = vi.init_params(fg, torch.Generator().manual_seed(0), cfg)
    bad = params._replace(mu=torch.full_like(params.mu, float("nan")))
    _, trace = vi._fit_from(fg, bad, cfg)
    assert torch.isnan(trace).all()
    with utils.nan_checks():
        with pytest.raises(FloatingPointError, match="NaN in elbo"):
            vi._fit_from(fg, bad, cfg)
        vi._fit_from(fg, params, cfg)
