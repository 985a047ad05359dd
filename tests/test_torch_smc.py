"""The port's annealed SMC held to the JAX reference and to exact oracles.

Deterministic pieces (the CESS bisection, the tempered leapfrog, one
reweight/resample step from the same particles and the same uniform) are
fed identical inputs in both packages. Whole anneals draw from torch
generators, so they are held to closed forms — log Z of a Gaussian from
its information form, the smoothed Kalman means — at the thresholds of the
reference's own tests (``tests/test_smc.py``, ``tests/test_smc_adaptive.py``).
"""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines import smc as ref_smc  # noqa: E402
from lhvi_tpu.models import lds as ref_lds  # noqa: E402
from lhvi_tpu.ops import logpot as ref_logpot  # noqa: E402
from lhvi_tpu.ops import resample as ref_rs  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
from lhvi_tpu_torch import Domain, F, Graph, RV  # noqa: E402
from lhvi_tpu_torch.engines import smc  # noqa: E402
from lhvi_tpu_torch.models import lds, toy  # noqa: E402
from lhvi_tpu_torch.ops import logpot  # noqa: E402
from lhvi_tpu_torch.potentials import GaussianPotential  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402
from lhvi_tpu_torch.utils.convert import smc_state_from_numpy  # noqa: E402


def _exact(fg):
    """(log Z, posterior mean) of a pure-Gaussian compiled graph from its
    own information form: ½hᵀJ⁻¹h + ½(n log 2π − log|J|) + c."""
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    sign, logdet = np.linalg.slogdet(J)
    assert sign > 0
    mean = np.linalg.solve(J, h)
    n = J.shape[0]
    return (0.5 * h @ mean + 0.5 * (n * math.log(2 * math.pi) - logdet)
            + float(fg.quad_c)), mean


@pytest.mark.parametrize("beta,target", [(0.0, 0.9), (0.3, 0.5), (0.9, 0.99)])
def test_choose_beta_matches_reference(beta, target):
    rng = np.random.default_rng(int(beta * 10))
    N = 2048
    lw = rng.normal(scale=0.5, size=N).astype(np.float32)
    lw = (lw - np.log(np.exp(lw.astype(np.float64)).sum())).astype(np.float32)
    dlp = (-40.0 + 8.0 * rng.normal(size=N)).astype(np.float32)
    tgt = np.log(np.float32(target * N)).astype(np.float32)
    want = float(jax.jit(ref_smc._choose_beta)(
        jnp.asarray(lw), jnp.asarray(dlp), jnp.float32(beta),
        jnp.float32(tgt)))
    got = float(smc._choose_beta(torch.from_numpy(lw), torch.from_numpy(dlp),
                                 torch.tensor(beta), torch.tensor(tgt)))
    assert beta < want <= 1.0
    assert abs(got - want) < 1e-6, (got, want)


def test_systematic_resample_is_the_weight_pipeline_search():
    """systematic_resample(gen, log_w) draws one uniform from ``gen`` and
    searches the softmax's cumulative weights, as the reference's
    (smc.py:103-116); it agrees with systematic_parents on the same
    uniform and the weight pipeline's ``cum``."""
    from lhvi_tpu_torch.ops.resample import systematic_parents, weight_pipeline

    lw = torch.from_numpy(np.random.default_rng(6).normal(size=300)
                          .astype(np.float32))
    got = smc.systematic_resample(torch.Generator().manual_seed(8), lw, 300)
    u0 = torch.rand((), generator=torch.Generator().manual_seed(8))
    want = systematic_parents(u0, weight_pipeline(lw)[1], 300)
    assert torch.equal(got, want)
    assert got.dtype == torch.int64 and bool((got[1:] >= got[:-1]).all())


def test_logpot_leapfrog_matches_reference():
    """The tempered autograd leapfrog on a pure-quadratic graph (Kalman,
    T=10): the same (x, p) give the same trajectory and energies within
    f32 rounding."""
    g_ref, *_ = ref_lds.kalman_lds(T=10, seed=1)
    g, *_ = lds.kalman_lds(T=10, seed=1)
    rfg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
    C, n = 64, fg.n_cont
    rng = np.random.default_rng(3)
    x = (2.0 * rng.normal(size=(C, n))).astype(np.float32)
    p = rng.normal(size=(C, n)).astype(np.float32)
    mid = np.zeros(n, np.float32)
    is2 = np.full(n, 0.25, np.float32)
    ones = np.ones(n, np.float32)
    want = ref_logpot._jnp_logpot_leapfrog(
        rfg, jnp.asarray(x), jnp.asarray(p), jnp.zeros((C, 0), jnp.int32),
        jnp.asarray(ones), 0.3, jnp.float32(0.4), jnp.asarray(mid),
        jnp.asarray(is2), 5, True)
    got = logpot.logpot_leapfrog(
        fg, torch.from_numpy(x), torch.from_numpy(p),
        torch.zeros((C, 0), dtype=torch.int64), torch.from_numpy(ones), 0.3,
        5, beta=torch.tensor(0.4), base_mid=torch.from_numpy(mid),
        base_inv_s2=torch.from_numpy(is2))
    for a, b, name in zip(got, want, ("x1", "p1", "lp0", "lp1")):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max(), err_msg=name)
    # plan="auto" resolves to the autograd path on CPU tensors (and a
    # pure-quadratic graph has no fused-kernel plan at all)
    assert logpot.logpot_plan(fg) is None
    auto = logpot.logpot_leapfrog(
        fg, torch.from_numpy(x), torch.from_numpy(p),
        torch.zeros((C, 0), dtype=torch.int64), torch.from_numpy(ones), 0.3,
        5, beta=torch.tensor(0.4), base_mid=torch.from_numpy(mid),
        base_inv_s2=torch.from_numpy(is2), plan="auto")
    for a, b in zip(auto, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("beta", [0.002, 0.6])
def test_reweight_resample_matches_reference(beta):
    """One reweight → weight pipeline → systematic resample step from the
    same particles (carried across with smc_state_from_numpy) and the
    same uniform: the reference's algebra (smc.py:207-237) gives the same
    log Z, log-weights and particles. β = 0.002 keeps the ESS above the
    trigger; β = 0.6 resamples."""
    g_ref, *_ = ref_lds.kalman_lds(T=8, seed=2)
    g, *_ = lds.kalman_lds(T=8, seed=2)
    rfg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
    N, n = 512, fg.n_cont
    rng = np.random.default_rng(4)
    rcfg, cfg = ref_smc.SMCConfig(n_particles=N), smc.SMCConfig(n_particles=N)
    lw = np.full(N, -np.log(N), np.float32)
    rs = ref_smc.SMCState(
        xc=jnp.asarray((2.0 * rng.normal(size=(N, n))).astype(np.float32)),
        xd=jnp.zeros((N, 0), jnp.int32), log_w=jnp.asarray(lw),
        log_z=jnp.float32(0.1), key=jax.random.PRNGKey(0))
    st = smc_state_from_numpy({k: np.asarray(v) for k, v in
                               rs._asdict().items()}, "cpu")
    k_res = jax.random.PRNGKey(11)
    dlp = (rfg.log_prob_batched(rs.xc, rs.xd)
           - ref_smc._base_log_prob(rfg, rcfg, rs.xc))
    lwn, cum, step_z, ess = ref_rs._jnp_weight_pipeline(
        rs.log_w + beta * dlp, N)
    need = bool(ess < 0.5 * N)
    assert need == (beta > 0.5)
    if need:
        idx = ref_rs.systematic_parents(k_res, cum, N)
        x_r, lw_r = np.asarray(rs.xc)[np.asarray(idx)], np.full(N, -np.log(N))
    else:
        x_r, lw_r = np.asarray(rs.xc), np.asarray(lwn)
    u0 = torch.tensor(float(jax.random.uniform(k_res, ())))
    new, ess_p = smc._reweight_resample(fg, cfg, st, torch.tensor(0.0),
                                        torch.tensor(beta), u0)
    np.testing.assert_allclose(float(ess_p), float(ess), rtol=1e-4)
    np.testing.assert_allclose(float(new.log_z), float(rs.log_z + step_z),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(new.log_w.numpy(), lw_r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(new.xc.numpy(), x_r)


def test_smc_gaussian_logz_and_moments():
    """tests/test_smc.py:16-28: a normalized density has log Z = 0."""
    dom = Domain([-20, 20], continuous=True)
    x = RV(dom, name="x")
    g = Graph([x], [F(GaussianPotential([2.0], [[1.5]]), [x])])
    fg = lt.compile_graph(g, "cpu")
    res = smc.sample(fg, torch.Generator().manual_seed(0),
                     smc.SMCConfig(n_particles=2048, n_temps=30, n_moves=2))
    assert abs(res.mean(x) - 2.0) < 0.08
    assert abs(res.var(x) - 1.5) / 1.5 < 0.15
    assert abs(res.log_z) < 0.1, res.log_z


def test_smc_kalman_smoothing():
    """tests/test_smc.py:31-44, with log Z against the closed form."""
    g, xs, _ = lds.kalman_lds(T=15, seed=0)
    fg = lt.compile_graph(g, "cpu")
    log_z, mean = _exact(fg)
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    var = np.diag(np.linalg.inv(J))
    res = smc.sample(fg, torch.Generator().manual_seed(1),
                     smc.SMCConfig(n_particles=4096, n_temps=50, n_moves=3,
                                   step_size=0.3))
    idx = [fg.meta.loc(rv)[1] for rv in xs]
    errs = [abs(res.mean(rv) - mean[i]) for rv, i in zip(xs, idx)]
    vrel = [abs(res.var(rv) - var[i]) / var[i] for rv, i in zip(xs, idx)]
    assert np.mean(errs) < 0.1, np.mean(errs)
    assert np.max(errs) < 0.3, np.max(errs)
    assert np.mean(vrel) < 0.3, np.mean(vrel)
    assert abs(res.log_z - log_z) < 0.3, (res.log_z, log_z)
    assert res.diag["ess"].shape == (50,) and int(res.diag["n_temps_used"]) == 50


def test_smc_quad_moves_match_autodiff_moves():
    """tests/test_smc.py:47-65: the fused quadratic move (K1's plain
    version on the CPU) and the autograd move sample the same target."""
    g, xs, _ = lds.kalman_lds(T=10, seed=1)
    fg = lt.compile_graph(g, "cpu")
    assert fg.cont_pure_quad
    _, mean = _exact(fg)
    outs = {}
    for qm in (False, True):
        res = smc.sample(fg, torch.Generator().manual_seed(4),
                         smc.SMCConfig(n_particles=2048, n_temps=40, n_moves=2,
                                       step_size=0.3, quad_moves=qm))
        outs[qm] = res
        errs = [abs(res.mean(rv) - mean[fg.meta.loc(rv)[1]]) for rv in xs]
        assert np.mean(errs) < 0.15, (qm, np.mean(errs))
    assert abs(outs[True].log_z - outs[False].log_z) < 0.5


def test_adaptive_logz_exact_gaussian():
    """tests/test_smc_adaptive.py:64-83: the adaptive anneal recovers
    log Z = 0 of a normalized 2-D Gaussian and ends at β = 1."""
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential([1.0, -2.0],
                                           [[1.0, 0.7], [0.7, 2.0]]), [a, b])])
    fg = lt.compile_graph(g, "cpu")
    cfg = smc.SMCConfig(n_particles=4096, n_temps=30, n_moves=2,
                        adaptive=True)
    *_, lz, diag = smc.run_smc(fg, torch.Generator().manual_seed(0), cfg)
    assert abs(float(lz)) < 0.1, float(lz)
    betas = diag["betas"].numpy()
    assert betas.shape == (30,) and betas[-1] == 1.0
    assert np.all(np.diff(np.clip(betas, 0, 1)) >= -1e-6)
    assert int(diag["n_temps_used"]) < 30


def test_smc_banded_grid_through_dia_move():
    """A 12×12 evidence grid forced past the dense cap lands on the banded
    DIA move (K2's plain version on the CPU): posterior means and log Z
    against the dense solve of the same graph."""
    g, _ = toy.gaussian_grid(12, 12, seed=0, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu", quad_max_n=64)
    assert fg.quad_sparse and fg.quad_dia_offsets is not None
    log_z, mean = _exact(lt.compile_graph(g, "cpu"))
    xc, _, log_w, lz, diag = smc.run_smc(
        fg, torch.Generator().manual_seed(2),
        smc.SMCConfig(n_particles=1024, n_temps=30, n_moves=3,
                      step_size=0.3))
    w = torch.softmax(log_w.double(), 0)
    m = (w[:, None] * xc.double()).sum(0).numpy()
    err = np.abs(m - mean)
    assert err.mean() < 0.1 and err.max() < 0.5, (err.mean(), err.max())
    assert abs(float(lz) - log_z) < 1.0, (float(lz), log_z)
    assert float(diag["accept"].mean()) > 0.5


def test_out_of_slice_paths_raise():
    """A particle count that does not divide over the ranks of a sharded
    particle axis raises before any collective (the port has no gathered
    fallback); ``mode_swap`` runs (without a discrete class it warns and
    anneals as without it)."""
    from lhvi_tpu_torch.parallel import ChainShard

    g, *_ = lds.kalman_lds(T=3, seed=0)
    fg = lt.compile_graph(g, "cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="do not divide over 3 ranks"):
        smc.run_smc(fg, gen, smc.SMCConfig(), shard=ChainShard(0, 3))
    with pytest.warns(UserWarning, match="no-op"):
        xc, *_ = smc.run_smc(fg, gen, smc.SMCConfig(n_particles=16, n_temps=3,
                                                    mode_swap=True))
    assert xc.shape == (16, fg.n_cont)


@pytest.mark.parametrize("route", ["planned", "all_rows"])
def test_smc_hybrid_chain(route):
    """tests/test_smc.py:68-77's thresholds: SMC with tempered Gibbs on
    hybrid_chain within 0.1 of the exact E[x1] and 0.06 of the exact
    P(d), through the color plan and through the all-rows sweep (the plan
    taken away); log Z within 0.1 of exact enumeration's."""
    import dataclasses

    g, (d, x1, x2) = toy.hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = lt.compile_graph(g, "cpu")
    assert fg.color_plan is not None
    if route == "all_rows":
        fg = dataclasses.replace(fg, color_plan=None)
    res = smc.sample(fg, torch.Generator().manual_seed(2),
                     smc.SMCConfig(n_particles=4096, n_temps=40, n_moves=2))
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.1
    assert np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.06
    assert abs(res.log_z - exact.log_z) < 0.1, (res.log_z, exact.log_z)


def test_lds_models_match_reference():
    """The port's LDS models give the reference's graphs: same RV
    names, evidence values and compiled information form."""
    for T, seed in ((5, 0), (20, 3)):
        g_ref, _, ys_r = ref_lds.kalman_lds(T=T, seed=seed)
        g, _, ys = lds.kalman_lds(T=T, seed=seed)
        np.testing.assert_array_equal(ys, ys_r)
        rfg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
        np.testing.assert_array_equal(fg.quad_J.numpy(), np.asarray(rfg.quad_J))
        np.testing.assert_array_equal(fg.quad_h.numpy(), np.asarray(rfg.quad_h))
    g_ref, xs_r, ss_r = ref_lds.switching_lds(T=6, seed=1)
    g, xs, ss = lds.switching_lds(T=6, seed=1)
    assert [rv.name for rv in g.rvs] == [rv.name for rv in g_ref.rvs]
    assert [rv.value for rv in g.rvs] == [rv.value for rv in g_ref.rvs]
