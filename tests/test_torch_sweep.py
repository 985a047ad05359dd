"""The HMC engine's hybrid path on the CPU: the single-pass value and
count updates against the per-value loops they replaced, the sweep's
span and counters, and ``run_hmc`` with K5's plain twin on a small
robot map against the benchmark's plain reference."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import lhvi_tpu_torch as lt
from lhvi_tpu_torch.engines import hmc
from lhvi_tpu_torch.models.toy import gaussian_grid
from lhvi_tpu_torch.utils import metrics
from portbench.registry import Registry


def _loop_values(vals, idx):
    """The per-value loop ``state_values`` and ``_disc_sel_values`` ran
    (a one-hot multiply-add over the value table)."""
    out = torch.zeros(idx.shape)
    for v in range(vals.shape[-1]):
        out = out + torch.where(idx == v, vals[None, :, v], 0.0)
    return out


def _spin_model():
    """Discrete latents whose values are not their indices (±1 and three
    uneven levels), two colours, beside a continuous latent."""
    s = [lt.RV(lt.Domain([-1.0, 1.0]), name=f"s{i}") for i in range(4)]
    q = lt.RV(lt.Domain([-0.5, 0.25, 2.0]), name="q")
    x = lt.RV(lt.Domain([-4.0, 4.0], continuous=True), name="x")
    from lhvi_tpu_torch.potentials import GaussianPotential, MLNPotential

    fs = [lt.F(MLNPotential(lambda a: a[0] * a[1], w=0.4,
                            formula_name="pair"), [s[i], s[i + 1]])
          for i in range(3)]
    fs += [lt.F(MLNPotential(lambda a: -((a[2] - a[0] - a[1]) ** 2) / 2,
                             w=1.0, formula_name="link"), [s[0], q, x]),
           lt.F(GaussianPotential([0.0], [[4.0]]), [x])]
    return lt.compile_graph(lt.Graph(s + [q, x], fs), "cpu")


def _robot_fg(n=12):
    from lhvi_tpu_torch.models.relational import (robot_map,
                                                  robot_scan_evidence)
    from lhvi_tpu_torch.relational.data import load_evidence

    text, _ = robot_scan_evidence(n, seed=0)
    return lt.compile_graph(robot_map(n, evidence=load_evidence(text))
                            .ground()[0], "cpu")


@pytest.mark.parametrize("table", ["state", "colour", "selected"])
def test_values_gather_equals_the_loop(table):
    """Each single gather gives the loop's values bit for bit: the whole
    value state (``state_values``), a colour class's new values (the
    sweep's ``xv`` update) and the monitored latents'
    (``_disc_sel_values``)."""
    fg = _spin_model()
    assert not fg.color_plan.values_are_indices
    g = torch.Generator().manual_seed(3)
    C = 257
    if table == "colour":
        grp = fg.color_plan.groups[0]
        vals = grp.vals_[0]
        idx = (torch.rand((C, grp.n_vars), generator=g)
               * grp.sizes[0][None]).long()
        got = hmc._values_of(vals, idx)
    else:
        xd = (torch.rand((C, fg.n_disc), generator=g)
              * fg.disc_sizes[None]).long()
        if table == "state":
            vals, idx, got = fg.disc_vals, xd, hmc.state_values(fg, xd)
        else:
            sel = torch.tensor([4, 0, 2])
            vals, idx = fg.disc_vals[sel], xd[:, sel]
            got = hmc._disc_sel_values(fg, sel, xd)
    want = _loop_values(vals, idx)
    assert got.dtype == want.dtype and torch.equal(
        got.view(torch.int32), want.view(torch.int32))


def test_planned_sweep_equals_the_loop_sweep(monkeypatch):
    """A sweep with a value state (values not indices) draws the same
    states bit for bit whether its value updates gather or loop."""
    fg = _spin_model()
    state = hmc.init_hmc_state(fg, torch.Generator().manual_seed(1),
                               hmc.HMCConfig(), 64)
    outs = []
    for loop in (False, True):
        if loop:
            monkeypatch.setattr(hmc, "_values_of", _loop_values)
        gen = torch.Generator().manual_seed(9)
        xd = state.xd
        for _ in range(3):
            xd = hmc.gibbs_sweep_planned(fg, gen, state.xc, xd)
        outs.append(xd)
    assert torch.equal(*outs)


def test_streamed_counts_equal_the_samples():
    """The moment stream's per-value counts (one ``one_hot`` sum a draw)
    equal the counts of the same chains' samples exactly, and its
    discrete split-R-hat equals the one formed from the samples' values."""
    fg = _spin_model()
    cfg = hmc.HMCConfig(init_step_size=0.3)
    kw = dict(n_chains=32, n_warmup=20, n_samples=30)
    s_xc, s_xd, _ = hmc.run_hmc(fg, torch.Generator().manual_seed(4), cfg,
                                collect="samples", **kw)
    mom, _, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(4), cfg,
                               collect="moments", **kw)
    n_obs = mom["n_obs"]
    counts = torch.nn.functional.one_hot(s_xd.reshape(-1, fg.n_disc),
                                         fg.max_v).sum(0)
    assert torch.equal(mom["disc_probs"], counts.float() / n_obs)
    vals = fg.disc_vals[torch.arange(fg.n_disc)[None, None], s_xd]
    h = 15
    halves = torch.cat([vals[:h], vals[h:2 * h]], dim=1).double()
    W = halves.var(0).mean(0)
    B = h * halves.mean(0).var(0)
    rhat = torch.sqrt(((h - 1) / h * W + B / h) / W)
    idx = diag["disc_diag_idx"]
    assert torch.allclose(diag["rhat_disc"].double(), rhat[idx], rtol=1e-4)


@pytest.mark.parametrize("sweeps", [1, 2])
def test_sweep_counters_count_classes_and_rows(sweeps):
    """``hmc.sweep_classes`` counts colours × sweeps × transitions, and
    ``hmc.sweep_rows`` each class's factor rows times candidate values, as
    the plan's tables have them; a model without discrete latents counts
    neither."""
    fg = _robot_fg()
    plan_rows = sum(grp.n_colors * fg.max_v * t["w"].shape[1]
                    for grp in fg.color_plan.groups
                    for t in grp.bucket_tabs if t is not None)
    before = metrics.counters()
    cfg = hmc.HMCConfig(init_step_size=0.05, gibbs_sweeps=sweeps)
    hmc.run_hmc(fg, torch.Generator().manual_seed(0), cfg, n_chains=8,
                n_warmup=4, n_samples=5, collect="moments")
    after = metrics.counters()
    T = 9
    assert fg.n_colors == 2
    assert (after["hmc.sweep_classes"] - before["hmc.sweep_classes"]
            == fg.n_colors * sweeps * T)
    assert (after["hmc.sweep_rows"] - before["hmc.sweep_rows"]
            == plan_rows * sweeps * T)
    grid = lt.compile_graph(gaussian_grid(3, 3, seed=0)[0], "cpu")
    before = metrics.counters()
    hmc.run_hmc(grid, torch.Generator().manual_seed(0), hmc.HMCConfig(),
                n_chains=4, n_warmup=2, n_samples=2, collect="moments")
    after = metrics.counters()
    assert after["hmc.sweep_classes"] == before["hmc.sweep_classes"]


def test_sweep_span_only_with_tracing_on():
    """With tracing off a transition records no span (the counters still
    count); with it on, ``hmc.sweep`` sits inside ``hmc.transition``, and
    a model without discrete latents records no ``hmc.sweep``."""
    fg = _robot_fg()
    cfg = hmc.HMCConfig(init_step_size=0.05)
    gen = torch.Generator().manual_seed(2)
    state = hmc.init_hmc_state(fg, gen, cfg, 8)
    metrics.reset_tracing()
    state, _ = hmc.hmc_transition(fg, cfg, state, gen, True)
    assert metrics.spans() == []
    assert metrics.counters()["hmc.sweep_classes"] == fg.n_colors
    with metrics.tracing():
        hmc.hmc_transition(fg, cfg, state, gen, True)
    recs = metrics.spans()
    metrics.reset_tracing()
    names = [r.name for r in recs]
    assert names.count("hmc.sweep") == 1 and "hmc.transition" in names
    sweep = recs[names.index("hmc.sweep")]
    assert recs[sweep.parent].name == "hmc.transition"
    grid = lt.compile_graph(gaussian_grid(3, 3, seed=0)[0], "cpu")
    grid_state = hmc.init_hmc_state(grid, gen, cfg, 4)
    with metrics.tracing():
        hmc.hmc_transition(grid, cfg, grid_state, gen, True)
    names = [r.name for r in metrics.spans()]
    metrics.reset_tracing()
    assert names == ["hmc.transition"]


def test_run_hmc_with_k5s_twin_meets_the_reference(monkeypatch):
    """``run_hmc`` with ``fused_logpot=True`` on a 12-segment robot map,
    every proposal through K5's plain twin (the tape evaluator, which
    ``plan="auto"`` takes on the card), against the benchmark's exact
    reference: the latent depth's mean and variance and every type
    marginal within 5 Monte Carlo standard errors at an integrated
    autocorrelation time of 4 draws."""
    from lhvi_tpu_torch.ops import logpot

    monkeypatch.setattr(logpot, "_resolve_plan", lambda fg, plan, x: (
        logpot.logpot_plan_cached(fg) if plan == "auto" else plan))
    reg = Registry()
    cfg = dict(reg.json("configs", "robot_map100"), n_segments=12,
               n_latent_types=9, n_latent_depths=1)
    ref = reg.module("reference", "robot_map100")
    inputs = ref.make_inputs(cfg, 4)
    built = reg.module("models", "robot_map100").build(cfg, inputs, "cpu")
    post = ref.posterior(cfg, inputs)
    C, S, tau = 128, 300, 4.0
    before = metrics.counters()["ops.k5.launches"]
    mom, _, diag = hmc.run_hmc(
        built["fg"], torch.Generator().manual_seed(1),
        hmc.HMCConfig(n_leapfrog=8, init_step_size=0.05, fused_logpot=True),
        n_chains=C, n_warmup=150, n_samples=S, collect="moments")
    assert metrics.counters()["ops.k5.launches"] == before  # no card here
    lay = built["layout"]
    n_eff = C * S / tau
    m = mom["mean"].double().numpy()[lay["cont"]]
    v = mom["var"].double().numpy()[lay["cont"]]
    p = mom["disc_probs"].double().numpy()[lay["disc"]][:, :3]
    P = post["type_probs"]
    assert np.all(np.abs(m - post["mean"]) <= 5 * np.sqrt(post["var"]
                                                          / n_eff))
    assert np.all(np.abs(v / post["var"] - 1) <= 5 * math.sqrt(4 / n_eff))
    assert np.all(np.abs(p - P) <= 5 * np.sqrt(P * (1 - P) / n_eff) + 1e-3)
    assert float(diag["accept_rate"]) > 0.5
