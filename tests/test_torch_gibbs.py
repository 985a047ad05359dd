"""The port's chromatic Gibbs (HMC-within-Gibbs) held to the JAX reference
and to exact answers.

Deterministic pieces are fed the same numpy inputs in both packages: the
conflict coloring, the ``GibbsGather`` and ``GibbsColorPlan`` tables are
EQUAL (the same numpy construction runs on both sides), and the
full-conditional logits (``disc_logits``, ``planned_logits``) at fixed
states agree to f32 rounding (rtol 1e-5, atol 1e-4, the reference's own
bound in ``tests/test_gibbs_plan.py``). Draws come from torch generators,
which cannot reproduce JAX's, so the samplers are held to exact
enumeration (the port's numpy ``ExactPosterior``) and closed forms within
Monte Carlo error.
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu as R  # noqa: E402
import lhvi_tpu.models.relational as ref_rel  # noqa: E402
import lhvi_tpu.models.toy as ref_toy  # noqa: E402
import lhvi_tpu.potentials as ref_pot  # noqa: E402
from lhvi_tpu.engines import hmc as ref_hmc  # noqa: E402
from lhvi_tpu.relational.data import load_evidence as ref_load  # noqa: E402
from lhvi_tpu.utils.oracle import ExactPosterior as RefExact  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.relational as rel  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
import lhvi_tpu_torch.potentials as pot  # noqa: E402
from lhvi_tpu_torch.engines import hmc  # noqa: E402
from lhvi_tpu_torch.ops import logpot  # noqa: E402
from lhvi_tpu_torch.relational.data import load_evidence  # noqa: E402
from lhvi_tpu_torch.utils.convert import (  # noqa: E402
    hmc_state_from_numpy,
    stream_diag_disc_from_numpy,
)
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

REF = types.SimpleNamespace(Domain=R.Domain, RV=R.RV, F=R.F, Graph=R.Graph,
                            pot=ref_pot, toy=ref_toy, rel=ref_rel,
                            load=ref_load)
PORT = types.SimpleNamespace(Domain=lt.Domain, RV=lt.RV, F=lt.F,
                             Graph=lt.Graph, pot=pot, toy=toy, rel=rel,
                             load=load_evidence)


def _repeated_slot(m):
    """A factor naming the same discrete latent twice (joint substitution)."""
    dom = m.Domain([0, 1, 2])
    a, b = m.RV(dom, name="a"), m.RV(dom, name="b")
    tbl = np.random.default_rng(0).uniform(0.5, 2.0, (3, 3))
    return m.Graph([a, b], [
        m.F(m.pot.TablePotential(tbl), [a, a]),
        m.F(m.pot.TablePotential(tbl), [a, b]),
        m.F(m.pot.TablePotential([1.0, 2.0, 0.5]), [b]),
    ])


def _mixed_domains(m):
    """Different domain sizes force per-var candidate masking."""
    d2, d4 = m.Domain([0, 1]), m.Domain([0, 1, 2, 3])
    a, b, c = m.RV(d2, name="a"), m.RV(d4, name="b"), m.RV(d2, name="c")
    x = m.RV(m.Domain([-5, 5], continuous=True), name="x")
    rng = np.random.default_rng(1)
    return m.Graph([a, b, c, x], [
        m.F(m.pot.TablePotential(rng.uniform(0.5, 2.0, (2, 4))), [a, b]),
        m.F(m.pot.TablePotential(rng.uniform(0.5, 2.0, (4, 2))), [b, c]),
        m.F(m.pot.MLNPotential(lambda ar: -((ar[1] - ar[0]) ** 2), w=0.7,
                               formula_name="link"), [a, x]),
    ])


def _nontrivial_domain(m):
    """tests/test_gibbs_plan.py:192: domain VALUES that are not 0..V-1, an
    observed slot and a repeated-slot factor."""
    dv, db = m.Domain([2.5, -1.0, 0.25]), m.Domain([-3.0, 7.0])
    a, b, c = m.RV(dv, name="a"), m.RV(db, name="b"), m.RV(dv, name="c")
    x = m.RV(m.Domain([-5, 5], continuous=True), name="x")
    c.value = 0.25
    M = m.pot.MLNPotential
    return m.Graph([a, b, c, x], [
        m.F(M(lambda ar: ar[0] * ar[1], w=0.3, formula_name="prod"), [a, b]),
        m.F(M(lambda ar: -((ar[0] - ar[1]) ** 2) / 4.0, w=0.5,
              formula_name="sqdiff"), [a, c]),
        m.F(M(lambda ar: ar[0] * ar[1], w=0.2, formula_name="self"), [b, b]),
        m.F(M(lambda ar: -((ar[1] - ar[0]) ** 2) / 8.0, w=0.4,
              formula_name="link"), [a, x]),
    ])


def _friends4(m):
    rg = m.rel.friends_smokers(n_people=4, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    return rg.ground()[0]


def _robot8(m):
    text, _ = m.rel.robot_scan_evidence(8, seed=0)
    return m.rel.robot_map(8, evidence=m.load(text)).ground()[0]


CASES = {
    "hybrid_chain": lambda m: m.toy.hybrid_chain()[0],
    "friends_smokers4": _friends4,
    "robot_map8": _robot8,
    "repeated_slot": _repeated_slot,
    "mixed_domains": _mixed_domains,
    "nontrivial_domain": _nontrivial_domain,
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    build = CASES[request.param]
    return (request.param, R.compile_graph(build(REF)),
            lt.compile_graph(build(PORT), "cpu"))


def _eq(got, want, what):
    if want is None or got is None:
        assert got is None and want is None, what
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def test_coloring_and_plan_tables_equal_reference(pair):
    """Coloring, GibbsGather and every GibbsColorPlan table are EQUAL."""
    name, ref, fg = pair
    assert (fg.n_colors, fg.n_disc, fg.max_v) == (ref.n_colors, ref.n_disc,
                                                  ref.max_v)
    _eq(fg.color_of, ref.color_of, (name, "color_of"))
    _eq(fg.meta.np_global["color_of"], ref.meta.np_global["color_of"], name)
    assert fg.gibbs.degrees == ref.gibbs.degrees
    for a, b in zip(fg.gibbs.idx, ref.gibbs.idx):
        _eq(a, b, (name, "gibbs.idx"))
    _eq(fg.gibbs.pos_of_var, ref.gibbs.pos_of_var, (name, "pos_of_var"))
    rp, pp = ref.color_plan, fg.color_plan
    assert pp.values_are_indices == rp.values_are_indices
    assert len(pp.groups) == len(rp.groups)
    for gi, (pg, rg) in enumerate(zip(pp.groups, rp.groups)):
        assert (pg.n_colors, pg.n_vars) == (rg.n_colors, rg.n_vars)
        for f in ("vars_", "sizes", "vals_"):
            _eq(getattr(pg, f), getattr(rg, f), (name, gi, f))
        for bi, (pt, rt) in enumerate(zip(pg.bucket_tabs, rg.bucket_tabs)):
            assert (pt is None) == (rt is None), (name, gi, bi)
            if rt is None:
                continue
            assert set(pt) == set(rt)
            for k in rt:
                if k == "params":
                    assert set(pt[k]) == set(rt[k])
                    for pk in rt[k]:
                        _eq(pt[k][pk], rt[k][pk], (name, gi, bi, pk))
                else:
                    _eq(pt[k], rt[k], (name, gi, bi, k))


def _fixed_states(fg, C, seed):
    rng = np.random.default_rng(seed)
    xc = rng.normal(0.0, 1.5, (C, fg.n_cont)).astype(np.float32)
    sizes = fg.meta.np_global["disc_sizes"]
    xd = (rng.uniform(size=(C, fg.n_disc)) * sizes[None]).astype(np.int64)
    return xc, xd


def test_disc_and_planned_logits_equal_reference(pair):
    """disc_logits and planned_logits at fixed states equal the
    reference's per-state results (valid candidate slots; rtol 1e-5, atol
    1e-4), and the port's two assemblies equal each other."""
    name, ref, fg = pair
    xc, xd = _fixed_states(fg, 6, seed=len(name))
    got = fg.disc_logits(torch.from_numpy(xc), torch.from_numpy(xd)).numpy()
    gotp = hmc.planned_logits(fg, torch.from_numpy(xc),
                              torch.from_numpy(xd)).numpy()
    valid = (np.arange(fg.max_v)[None, :]
             < fg.meta.np_global["disc_sizes"][:, None])
    for i in range(xc.shape[0]):
        a, b = jnp.asarray(xc[i]), jnp.asarray(xd[i].astype(np.int32))
        want = np.asarray(ref.disc_logits(a, b))
        wantp = np.asarray(ref_hmc.planned_logits(ref, a, b))
        for g_, w_, what in ((got[i], want, "disc_logits"),
                             (gotp[i], wantp, "planned_logits"),
                             (gotp[i], got[i], "planned vs all-rows")):
            np.testing.assert_allclose(g_[valid], w_[valid], rtol=1e-5,
                                       atol=1e-4, err_msg=f"{name} {what}")
            assert np.all(g_[~valid] == -1e30)
    # one state without the chain axis
    one = fg.disc_logits(torch.from_numpy(xc[0]), torch.from_numpy(xd[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_tempered_sweep_logits_are_beta_times_reference(pair, monkeypatch):
    """SMC's tempered Gibbs at a fixed state: the all-rows sweep's first
    color step draws from β × the reference's ``disc_logits`` (its SMC
    color step, smc.py:377-392), and the planned sweep's first color
    class from β × the reference's planned logits of that class, on valid
    candidates (rtol 1e-5, atol 1e-4 as above); the planned sweep's
    invalid candidates stay at −1e30."""
    name, ref, fg = pair
    beta = 0.37
    xc, xd = _fixed_states(fg, 4, seed=3 + len(name))
    seen = []
    monkeypatch.setattr(hmc, "categorical", lambda gen, logits: (
        seen.append(logits) or torch.zeros(logits.shape[:-1],
                                           dtype=torch.int64)))
    txc, txd = torch.from_numpy(xc), torch.from_numpy(xd)
    hmc.gibbs_sweep(fg, None, txc, txd.clone(), beta=beta)
    all_rows = seen[0].numpy()
    seen.clear()
    hmc.gibbs_sweep_planned(fg, None, txc, txd.clone(),
                            beta=torch.tensor(beta))
    planned = seen[0].numpy()
    grp = fg.color_plan.groups[0]
    vars_ = grp.vars_[0].numpy()
    sizes = fg.meta.np_global["disc_sizes"]
    valid = np.arange(fg.max_v)[None, :] < sizes[:, None]
    for i in range(xc.shape[0]):
        a, b = jnp.asarray(xc[i]), jnp.asarray(xd[i].astype(np.int32))
        want = beta * np.asarray(ref.disc_logits(a, b))
        np.testing.assert_allclose(all_rows[i][valid], want[valid],
                                   rtol=1e-5, atol=1e-4, err_msg=name)
        wantp = beta * np.asarray(ref_hmc.planned_logits(ref, a, b))
        for m, v in enumerate(vars_):
            if v >= fg.n_disc:  # a padded class slot
                continue
            ok = valid[v]
            np.testing.assert_allclose(planned[i, m][ok], wantp[v][ok],
                                       rtol=1e-5, atol=1e-4, err_msg=name)
            assert np.all(planned[i, m][~ok] == -1e30)


def _exact_marginals_run(fg, sweep, C, S, burn, seed):
    """S sweeps of all chains from fresh states → [S - burn, C, n_disc]."""
    gen = torch.Generator().manual_seed(seed)
    xc, xd = fg.init_state_batched(gen, C)
    hist = []
    for s in range(S):
        xd = sweep(gen, xc, xd)
        if s >= burn:
            hist.append(xd)
    return torch.stack(hist).numpy()


@pytest.mark.parametrize("path", ["planned", "all_rows"])
def test_sweep_matches_exact_marginals(path):
    """tests/test_gibbs_plan.py:90-124: a discrete chain's marginals from
    the planned sweep and from the rotated all-rows path
    (gibbs_max_colors=1) within 0.02 of exact enumeration."""
    dom = lt.Domain([0, 1])
    rvs = [lt.RV(dom, name=f"z{i}") for i in range(5)]
    rng = np.random.default_rng(3)
    fs = [lt.F(pot.TablePotential([1.0, 1.8]), [rvs[0]])]
    for i in range(4):
        fs.append(lt.F(pot.TablePotential(rng.uniform(0.5, 2.0, (2, 2))),
                       [rvs[i], rvs[i + 1]]))
    g = lt.Graph(rvs, fs)
    exact = ExactPosterior(g)
    fg = lt.compile_graph(g, "cpu")
    if path == "planned":
        sweep = lambda gen, xc, xd: hmc.gibbs_sweep_planned(  # noqa: E731
            fg, gen, xc, xd)
        S = 400
    else:
        sweep = lambda gen, xc, xd: hmc.gibbs_sweep(  # noqa: E731
            fg, gen, xc, xd, max_colors=1)
        S = 800  # one of the two colors per sweep
    hist = _exact_marginals_run(fg, sweep, 256, S, 100, seed=0)
    for i, rv in enumerate(rvs):
        assert abs(hist[..., i].mean() - exact.disc_marginal(rv)[1]) < 0.02


def test_nontrivial_domain_sweep_matches_exact():
    """The value-space tables in the sweep itself (tests/test_gibbs_plan.py
    :218-242): marginals within 0.03 of exact enumeration."""
    g = _nontrivial_domain(PORT)
    fg = lt.compile_graph(g, "cpu")
    assert not fg.color_plan.values_are_indices
    a, b = g.rvs[0], g.rvs[1]
    exact = ExactPosterior(g, cont_grid=121)
    hist = _exact_marginals_run(
        fg, lambda gen, xc, xd: hmc.gibbs_sweep_planned(fg, gen, xc, xd),
        256, 600, 100, seed=1)
    for rv in (a, b):
        i = fg.meta.loc(rv)[1]
        got = np.array([(hist[..., i] == k).mean()
                        for k in range(rv.domain.size)])
        assert np.abs(got - exact.disc_marginal(rv)).max() < 0.03, rv.name


def _small_robot(m):
    """tests/test_robot_map.py:15-23: 5 segments, depths observed on all
    but s1/s3, one labeled type."""
    text, _ = m.rel.robot_scan_evidence(5, seed=2, depth_miss_every=2,
                                        n_type_labels=1)
    return m.rel.robot_map(5, evidence=m.load(text)).ground()


def test_exact_posterior_matches_reference():
    """The port's numpy oracle equals the reference's on the small robot
    instance (same grid; f32 kernels on both sides)."""
    g_r, idx_r = _small_robot(REF)
    g_p, idx_p = _small_robot(PORT)
    er, ep = RefExact(g_r, cont_grid=41), ExactPosterior(g_p, cont_grid=41)
    assert ep.log_z == pytest.approx(er.log_z, rel=1e-6)
    for key, rv in idx_p.items():
        if rv.observed:
            continue
        if rv.domain.continuous:
            assert ep.mean(rv) == pytest.approx(er.mean(idx_r[key]), abs=1e-6)
            assert ep.var(rv) == pytest.approx(er.var(idx_r[key]), abs=1e-6)
        else:
            np.testing.assert_allclose(ep.disc_marginal(rv),
                                       er.disc_marginal(idx_r[key]),
                                       atol=1e-6)


@pytest.mark.parametrize("route", ["autograd", "plan"])
def test_robot_small_instance_matches_exact(route, monkeypatch):
    """tests/test_robot_map.py:37-55's thresholds (type marginals within
    0.06, depth means within 0.08, variances within 0.1) for
    HMC-within-Gibbs through the autograd proposal and through the fused
    kernel's route (``fused_logpot=True``, the plan forced on CPU tensors,
    where K5's plain twin runs)."""
    g, index = _small_robot(PORT)
    exact = ExactPosterior(g, cont_grid=81)
    fg = lt.compile_graph(g, "cpu")
    calls = []
    if route == "plan":
        orig = logpot._plan_leapfrog
        monkeypatch.setattr(logpot, "_resolve_plan",
                            lambda fg_, plan, x: logpot.logpot_plan_cached(fg_)
                            if plan == "auto" else plan)
        monkeypatch.setattr(logpot, "_plan_leapfrog",
                            lambda *a: calls.append(1) or orig(*a))
    cfg = hmc.HMCConfig(n_leapfrog=8, init_step_size=0.2, gibbs_sweeps=2,
                        fused_logpot=route == "plan")
    res = hmc.sample(fg, torch.Generator().manual_seed(0), cfg=cfg,
                     n_chains=256, n_warmup=300, n_samples=600,
                     collect="moments")
    assert (len(calls) > 0) == (route == "plan")
    for i in range(5):
        rv_t = index[("type", (f"s{i}",))]
        if not rv_t.observed:
            got = res.disc_marginal(rv_t)
            want = exact.disc_marginal(rv_t)
            assert np.abs(got - want).max() < 0.06, (i, got, want)
        rv_d = index[("depth", (f"s{i}",))]
        if not rv_d.observed:
            assert abs(res.mean(rv_d) - exact.mean(rv_d)) < 0.08, i
            assert abs(res.var(rv_d) - exact.var(rv_d)) < 0.1, i
    assert np.all(np.abs(res.diag["rhat_disc"] - 1.0) < 0.05)


def _verify_model():
    """The verify skill's toy model: w ∈ {0, 1} with prior (0.8, 0.2) and a
    link whose normalization over t does not depend on w."""
    w = lt.RV(lt.Domain([0, 1]), name="w")
    t = lt.RV(lt.Domain([-20, 40], continuous=True), name="t")
    g = lt.Graph([w, t], [
        lt.F(pot.TablePotential([0.8, 0.2]), [w]),
        lt.F(pot.MLNPotential(lambda a: -((a[1] - (15.0 - 10.0 * a[0])) ** 2)
                              / 50.0, w=1.0, formula_name="link"), [w, t]),
    ])
    return g, w, t


@pytest.mark.parametrize("model", ["hybrid_chain", "verify_skill"])
def test_closed_forms(model):
    """hybrid_chain: P(d) = (0.3, 0.7) (the switch's normalization is
    d-independent), E[x1] = 0.4·(1.25/1.5) = 1/3, E[x2] = 0.4/1.5 = 4/15;
    the skill's model: P(w) = (0.8, 0.2), E[t] = 0.8·15 + 0.2·5 = 13.
    Bounds: 0.025 on probabilities and 0.05 on E[x] (hybrid_chain), 0.3 on
    E[t] (sd 5.4) — about 4 Monte Carlo standard errors of 512 chains ×
    400 correlated draws."""
    if model == "hybrid_chain":
        g, (d, x1, x2) = toy.hybrid_chain()
        want_p, mean_rv, want_m, tol_m = (0.3, 0.7), x1, 1.0 / 3.0, 0.05
    else:
        g, d, mean_rv = _verify_model()
        want_p, want_m, tol_m = (0.8, 0.2), 13.0, 0.3
    fg = lt.compile_graph(g, "cpu")
    res = hmc.sample(fg, torch.Generator().manual_seed(1),
                     cfg=hmc.HMCConfig(init_step_size=0.2), n_chains=512,
                     n_warmup=200, n_samples=400, collect="moments")
    np.testing.assert_allclose(res.disc_marginal(d), want_p, atol=0.025)
    assert abs(res.mean(mean_rv) - want_m) < tol_m, res.mean(mean_rv)
    if model == "hybrid_chain":
        assert abs(res.mean(x2) - 4.0 / 15.0) < 0.05
    assert res.map(d) == (1 if want_p[1] > 0.5 else 0)


def test_samples_mode_disc_marginal():
    """collect="samples" carries the discrete draws; HMCResult's marginal
    over them matches the moments mode's closed form."""
    g, d, t = _verify_model()
    fg = lt.compile_graph(g, "cpu")
    s_xc, s_xd, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(2),
                                   hmc.HMCConfig(init_step_size=0.3),
                                   n_chains=256, n_warmup=150, n_samples=200)
    assert s_xd.shape == (200, 256, 1) and s_xd.dtype == torch.int64
    res = hmc.HMCResult(fg, s_xc, s_xd, diag)
    np.testing.assert_allclose(res.disc_marginal(d), (0.8, 0.2), atol=0.03)
    assert abs(res.mean(t) - 13.0) < 0.4


def test_disc_diag_select_matches_reference():
    """The monitored discrete subset above the cap is the reference's
    (same color-stratified allocation, same numpy RNG)."""
    g_r, g_p = _robot8(REF), _robot8(PORT)
    ref, fg = R.compile_graph(g_r), lt.compile_graph(g_p, "cpu")
    for cap in (3, 5, fg.n_disc, fg.n_disc + 4):
        np.testing.assert_array_equal(hmc.disc_diag_select(fg, cap),
                                      ref_hmc.disc_diag_select(ref, cap))


def test_stream_diag_disc_matches_reference():
    """Streamed split-R̂ over discrete value traces: the same draws give
    the reference's rhat_disc (rtol 1e-5), including a latent frozen at
    one value (1.0) and one stuck at different values per chain (large).
    The reference's accumulators are carried across after half of the
    draws (``stream_diag_disc_from_numpy``) and the port continues."""
    S, C, n = 40, 6, 4
    rng = np.random.default_rng(5)
    draws = rng.integers(0, 3, (S, C, n)).astype(np.float32)
    draws[:, :, 2] = 1.0  # frozen everywhere
    draws[:, :, 3] = np.arange(C, dtype=np.float32)[None]  # stuck per chain
    half = S // 2
    sdd_r = ref_hmc._stream_diag_disc_init(C, n)
    for t in range(S // 2):
        sdd_r = ref_hmc._stream_diag_disc_update(sdd_r, jnp.int32(t),
                                                 jnp.asarray(draws[t]), half)
    sdd = stream_diag_disc_from_numpy(
        {k: np.asarray(v) for k, v in sdd_r._asdict().items()}, "cpu")
    for t in range(S // 2, S):
        sdd_r = ref_hmc._stream_diag_disc_update(sdd_r, jnp.int32(t),
                                                 jnp.asarray(draws[t]), half)
        sdd = hmc._stream_diag_disc_update(sdd, t, torch.from_numpy(draws[t]),
                                           half)
    want = np.asarray(ref_hmc._stream_diag_disc_finalize(sdd_r, S)["rhat_disc"])
    got = hmc._stream_diag_disc_finalize(sdd, S)["rhat_disc"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] == 1.0 and got[3] > 10.0


def test_hmc_state_from_numpy_carries_discrete_state():
    """A reference HMC state of a hybrid model crosses with its discrete
    index state (int64), and one Gibbs sweep from it stays valid."""
    g_r, g_p = _robot8(REF), _robot8(PORT)
    ref, fg = R.compile_graph(g_r), lt.compile_graph(g_p, "cpu")
    rs = ref_hmc.init_hmc_state(ref, jax.random.PRNGKey(3),
                                ref_hmc.HMCConfig(), 16)
    st = hmc_state_from_numpy({k: np.asarray(v)
                               for k, v in rs._asdict().items()}, "cpu")
    assert st.xd.dtype == torch.int64
    np.testing.assert_array_equal(st.xd.numpy(), np.asarray(rs.xd))
    xd = hmc.sweep_all(fg, hmc.HMCConfig(), torch.Generator().manual_seed(0),
                       st.xc, st.xd)
    sizes = torch.from_numpy(fg.meta.np_global["disc_sizes"]).long()
    assert xd.shape == st.xd.shape
    assert bool(((xd >= 0) & (xd < sizes[None])).all())
