"""The port's hybrid LBP and EPBP (``lhvi_tpu_torch/engines/lbp.py``,
``epbp.py``) held to the JAX reference on the CPU.

Deterministic parity (each graph built in both packages from one numpy
seed, or mirrored object by object):
- LBP: the factor tables over the support grids (rtol 1e-5: the
  parameter axis sits after the factor axis in both), then marginals,
  means, variances and ``belief(x)`` after the same iterations within
  atol 1e-4, on random discrete trees, the hybrid chain, a Gaussian chain
  and the lifted star graph (tests/test_lbp.py, tests/test_fuzz_bp.py);
  the density query from messages carried across
  (``utils/convert.py::lbp_msgs_from_numpy``);
- EPBP: ``_log_q``, ``_beliefs_of`` and ``_update_msgs`` on the
  reference's final supports and messages carried across
  (``epbp_state_from_numpy``) within rtol 1e-5, and a whole run from the
  reference's own proposal normals.

Statistical (torch's Philox cannot reproduce threefry): EPBP's runs
against exact answers at the reference tests' thresholds
(tests/test_epbp.py, tests/test_fuzz_bp.py, tests/test_density_queries.py).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.engines.epbp as ref_epbp  # noqa: E402
import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import Domain as RDomain, F as RF, Graph as RGraph, RV as RRV  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines.lbp import HybridLBP as RefLBP  # noqa: E402
from lhvi_tpu.lift import compile_lifted as ref_compile_lifted  # noqa: E402
from lhvi_tpu.potentials import (  # noqa: E402
    GaussianPotential as RGauss,
    LinearGaussianPotential as RLinGauss,
    TablePotential as RTable,
)

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch.engines import epbp, gabp  # noqa: E402
from lhvi_tpu_torch.engines.lbp import HybridLBP  # noqa: E402
from lhvi_tpu_torch.lift import compile_lifted  # noqa: E402
from lhvi_tpu_torch.utils.convert import (  # noqa: E402
    epbp_state_from_numpy,
    lbp_msgs_from_numpy,
)
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

from test_fuzz_bp import _rand_tree_edges  # noqa: E402
from test_lift import star_graph  # noqa: E402
from test_torch_compile import _mirror  # noqa: E402

# off-grid query points (tests/test_density_queries.py)
XQ = np.array([-2.831, -1.117, -0.303, 0.517, 1.293, 2.719])


def _rand_discrete_tree_ref(seed):
    """tests/test_fuzz_bp.py:30-52's random discrete tree."""
    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(4, 8))
    rvs = [RRV(RDomain(list(range(int(rng.integers(2, 5))))), name=f"d{i}")
           for i in range(n)]
    factors = []
    for i in range(n):
        t = rng.uniform(0.2, 1.0, size=len(rvs[i].domain.values))
        factors.append(RF(RTable(list(t)), [rvs[i]]))
    for a, b in _rand_tree_edges(rng, n):
        t = rng.uniform(0.2, 1.5, size=(len(rvs[a].domain.values),
                                        len(rvs[b].domain.values)))
        factors.append(RF(RTable(t), [rvs[a], rvs[b]]))
    if rng.integers(0, 2):
        rv = rvs[int(rng.integers(1, n))]
        rv.value = rv.domain.values[int(rng.integers(0, len(rv.domain.values)))]
    return RGraph(rvs, factors), n


def _hybrid_chain_pair():
    g_ref, (d, x1, x2) = ref_toy.hybrid_chain()
    g, _ = toy.hybrid_chain()
    for gg in (g_ref, g):
        for rv in gg.rvs[1:]:
            rv.domain.integral_points = np.linspace(-6, 6, 64)
    return g_ref, g


def _gauss_chain_ref(ip=None, mu=0.5, sig=1.5, lim=8):
    dom = RDomain([-lim, lim], continuous=True, integral_points=ip)
    xs = [RRV(dom, name=f"x{i}") for i in range(4)]
    fs = [RF(RGauss([mu], [[1.0]]), [xs[0]])]
    for i in range(3):
        fs.append(RF(RLinGauss(0.7, sig), [xs[i], xs[i + 1]]))
    return RGraph(xs, fs)


def _lbp_cases():
    """(name, reference compiled, port compiled, iters, damping)."""
    out = []
    for seed in range(6):
        g_ref, n = _rand_discrete_tree_ref(seed)
        out.append((f"tree{seed}", ref_compile(g_ref),
                    lt.compile_graph(_mirror(g_ref), "cpu"), 2 * n, 0.0))
    g_ref, g = _hybrid_chain_pair()
    out.append(("hybrid_chain", ref_compile(g_ref),
                lt.compile_graph(g, "cpu"), 30, 0.2))
    g_ref = _gauss_chain_ref(np.linspace(-8, 8, 80))
    out.append(("gauss_chain", ref_compile(g_ref),
                lt.compile_graph(_mirror(g_ref), "cpu"), 25, 0.2))
    g_ref, _, _ = star_graph(5)
    for rv in g_ref.rvs:
        rv.domain.integral_points = np.linspace(-6, 6, 48)
    out.append(("star_lifted", ref_compile_lifted(g_ref),
                compile_lifted(_mirror(g_ref), "cpu"), 25, 0.2))
    return out


_LBP = _lbp_cases()


@pytest.mark.parametrize("case", range(len(_LBP)), ids=[c[0] for c in _LBP])
def test_lbp_matches_reference(case):
    """Tables, marginals, means, variances (atol 1e-4) and ``belief`` at
    off-grid points (atol 1e-4 relative to the density's peak)."""
    _, ref_fg, fg, iters, damping = _LBP[case]
    ref = RefLBP(ref_fg).run(n_iters=iters, damping=damping)
    eng = HybridLBP(fg).run(n_iters=iters, damping=damping)
    assert eng.S == ref.S
    for t, rt in zip(eng.tables, ref.tables):
        want = np.asarray(rt.log_phi)
        np.testing.assert_allclose(t.log_phi.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(want).max()))
        np.testing.assert_array_equal(t.gvid.numpy(), np.asarray(rt.gvid))
        np.testing.assert_allclose(t.w_edge.numpy(), np.asarray(rt.w_edge))
    rmap = {rv.name: rv for rv in ref_fg.meta.graph.rvs}
    for rv in fg.meta.graph.rvs:
        if rv.observed:
            continue
        rr = rmap[rv.name]
        if rv.domain.continuous:
            assert abs(eng.mean(rv) - ref.mean(rr)) < 1e-4
            assert abs(eng.var(rv) - ref.var(rr)) < 1e-4
            got, want = eng.belief(XQ, rv), ref.belief(XQ, rr)
            assert np.abs(got - want).max() < 1e-4 * (1 + want.max())
        else:
            np.testing.assert_allclose(eng.disc_marginal(rv),
                                       ref.disc_marginal(rr), atol=1e-4)
        assert eng.map(rv) == pytest.approx(ref.map(rr))


def test_lbp_query_from_carried_messages():
    """The density query alone: the reference's converged messages and
    beliefs carried into the port give its ``belief``/``probability`` at
    off-grid points (rtol 1e-5)."""
    g_ref, g = _hybrid_chain_pair()
    ref = RefLBP(ref_compile(g_ref)).run(n_iters=30)
    eng = HybridLBP(lt.compile_graph(g, "cpu"))
    eng.msgs = lbp_msgs_from_numpy(ref.msgs, "cpu")
    eng.beliefs_ = np.asarray(ref.beliefs_)
    for rv, rr in zip(g.rvs[1:], g_ref.rvs[1:]):
        np.testing.assert_allclose(eng.belief(XQ, rv), ref.belief(XQ, rr),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(eng.probability(XQ, rv),
                                   ref.probability(XQ, rr), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("case", range(7), ids=[c[0] for c in _LBP[:7]])
def test_lbp_against_exact(case):
    """tests/test_fuzz_bp.py:30-58 (trees: within 1e-3 of enumeration) and
    tests/test_lbp.py:33-42, tests/test_density_queries.py:52-71 (the
    hybrid chain: P(d) within 0.05, means within 0.1, belief within 0.06,
    integrating to 1 within 0.05)."""
    name, _, fg, iters, damping = _LBP[case]
    g = fg.meta.graph
    eng = HybridLBP(fg).run(n_iters=iters, damping=damping)
    if name == "hybrid_chain":
        d, x1, x2 = g.rvs
        exact = ExactPosterior(g, cont_grid=161)
        assert np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.05
        for rv in (x1, x2):
            assert abs(eng.mean(rv) - exact.mean(rv)) < 0.1
            assert np.abs(eng.belief(XQ, rv) - exact.density(XQ, rv)).max() < 0.06
            xs = np.linspace(-6.0, 6.0, 301)
            assert abs(np.trapezoid(eng.belief(xs, rv), xs) - 1.0) < 0.05
            p, b = eng.probability(XQ, rv), eng.belief(XQ, rv)
            ratios = p[b > 1e-8] / b[b > 1e-8]
            assert ratios.max() / ratios.min() < 1.0 + 1e-6
        assert abs(eng.belief(0, d) - eng.disc_marginal(d)[0]) < 1e-12
        return
    exact = ExactPosterior(g)
    for rv in g.rvs:
        if rv.value is None:
            want = exact.disc_marginal(rv)
            np.testing.assert_allclose(eng.disc_marginal(rv)[: len(want)],
                                       want, atol=1e-3)


def test_lbp_gaussian_chain_and_lifted_star():
    """tests/test_lbp.py:45-80: the Gaussian chain against the dense solve
    (means within 0.1, variances within 20%), lifted LBP on the star graph
    against grounded LBP (1e-3, 5e-3)."""
    fg = _LBP[7][2]
    g = fg.meta.graph
    eng = HybridLBP(fg).run(n_iters=25)
    dense, _ = gabp.dense_gaussian_marginals(g)
    for rv in g.rvs:
        m, v = dense[id(rv)]
        assert abs(eng.mean(rv) - m) < 0.1
        assert abs(eng.var(rv) - v) / v < 0.2
    g_ref, _, _ = star_graph(5)
    for rv in g_ref.rvs:
        rv.domain.integral_points = np.linspace(-6, 6, 48)
    g = _mirror(g_ref)
    center, leaf = g.rvs[0], g.rvs[1]
    eng_g = HybridLBP(lt.compile_graph(g, "cpu")).run(n_iters=25)
    eng_l = HybridLBP(compile_lifted(g, "cpu")).run(n_iters=25)
    assert abs(eng_g.mean(center) - eng_l.mean(center)) < 1e-3
    assert abs(eng_g.mean(leaf) - eng_l.mean(leaf)) < 1e-3
    assert abs(eng_g.var(leaf) - eng_l.var(leaf)) < 5e-3


# ---- EPBP ---------------------------------------------------------------


def _ref_normals(fg_ref, key, P, n_iters):
    """The reference's proposal normals (``_epbp_run``'s key splits)."""
    k0, key = jax.random.split(key)
    shape = (max(fg_ref.n_cont, 1), P)
    eps = [jax.random.normal(k0, shape)]
    eps += [jax.random.normal(k, shape)
            for k in jax.random.split(key, n_iters)]
    return [torch.from_numpy(np.asarray(e)) for e in eps]


def _epbp_cases():
    g_ref, _ = ref_toy.hybrid_chain()
    g, _ = toy.hybrid_chain()
    out = [("hybrid_chain", ref_compile(g_ref), lt.compile_graph(g, "cpu"),
            64, 1)]
    g_ref = _gauss_chain_ref(None, mu=1.0, sig=1.2, lim=10)
    out.append(("gauss_chain", ref_compile(g_ref),
                lt.compile_graph(_mirror(g_ref), "cpu"), 64, 0))
    return out


_EPBP = _epbp_cases()


@pytest.mark.parametrize("case", range(len(_EPBP)),
                         ids=[c[0] for c in _EPBP])
def test_epbp_pieces_match_reference(case):
    """``_log_q``, ``_beliefs_of`` and the unnormalized and normalized
    ``_update_msgs`` on the reference's final EPBP state carried across:
    rtol 1e-5 (atol 1e-5 relative to the largest magnitude)."""
    _, ref_fg, fg, P, seed = _EPBP[case]
    cfg_r = ref_epbp.EPBPConfig(n_particles=P, n_iters=10)
    ref = ref_epbp.EPBP(ref_fg, cfg_r).run(jax.random.PRNGKey(seed))
    st = epbp_state_from_numpy(
        {"q_mu": ref.q_mu, "q_var": ref.q_var, "sup": ref._sup_j,
         "sup_grid": ref._sup_grid_j, "lq": ref._lq_j, "msgs": ref._msgs_j},
        "cpu")
    cfg = epbp.EPBPConfig(n_particles=P, n_iters=10)
    eng = epbp.EPBP(fg, cfg)
    W = epbp._table_width(fg, P)
    n_var = max(fg.n_cont + fg.n_disc, 1)

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * (1 + np.abs(want).max()))

    close(epbp._log_q(fg, st["sup"], st["q_mu"], st["q_var"], W, n_var),
          ref_epbp._log_q(ref_fg, ref._sup_j, jnp.asarray(ref.q_mu),
                          jnp.asarray(ref.q_var), W, n_var))
    close(epbp._beliefs_of(st["msgs"], eng.bidx, eng.edge_plan, n_var, W),
          ref_epbp._beliefs_of(ref._msgs_j, ref.bidx, ref.edge_plan, n_var, W))
    sup_idx, dmask = epbp._static_tables(fg, P)
    r_idx, r_mask = ref_epbp._static_tables(ref_fg, P)
    np.testing.assert_array_equal(sup_idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(dmask.numpy(), np.asarray(r_mask))
    for normalize in (False, True):
        got = epbp._update_msgs(fg, eng.bidx, eng.edge_plan, dmask, sup_idx,
                                n_var, P, st["sup"], st["msgs"], st["lq"],
                                st["sup_grid"], normalize=normalize)
        want = ref_epbp._update_msgs(ref_fg, ref.bidx, ref.edge_plan, r_mask,
                                     r_idx, n_var, P, ref._sup_j, ref._msgs_j,
                                     ref._lq_j, ref._sup_grid_j,
                                     normalize=normalize)
        for a, b in zip(got, want):
            close(a, b)


@pytest.mark.parametrize("case", range(len(_EPBP)),
                         ids=[c[0] for c in _EPBP])
def test_epbp_run_from_reference_normals(case):
    """A whole run from the reference's own proposal normals: the final
    proposals, marginals, means, variances and off-grid beliefs agree
    (atol 1e-3: 10 iterations of moment matching in f32)."""
    _, ref_fg, fg, P, seed = _EPBP[case]
    n_iters = 10
    ref = ref_epbp.EPBP(ref_fg, ref_epbp.EPBPConfig(n_particles=P)).run(
        jax.random.PRNGKey(seed), n_iters)
    eng = epbp.EPBP(fg, epbp.EPBPConfig(n_particles=P)).run_from(
        _ref_normals(ref_fg, jax.random.PRNGKey(seed), P, n_iters))
    np.testing.assert_allclose(eng.q_mu, ref.q_mu, atol=1e-3)
    np.testing.assert_allclose(eng.q_var, ref.q_var, rtol=1e-3, atol=1e-4)
    rmap = {rv.name: rv for rv in ref_fg.meta.graph.rvs}
    for rv in fg.meta.graph.rvs:
        rr = rmap[rv.name]
        if rv.domain.continuous:
            assert abs(eng.mean(rv) - ref.mean(rr)) < 1e-3
            assert abs(eng.var(rv) - ref.var(rr)) < 1e-3
            got, want = eng.belief(XQ, rv), ref.belief(XQ, rr)
            assert np.abs(got - want).max() < 1e-3
        else:
            np.testing.assert_allclose(eng.disc_marginal(rv),
                                       ref.disc_marginal(rr), atol=1e-3)


def _run(fg, P, n_iters, seed):
    return epbp.EPBP(fg, epbp.EPBPConfig(n_particles=P, n_iters=n_iters)).run(
        torch.Generator().manual_seed(seed))


def test_epbp_hybrid_chain_against_exact():
    """tests/test_epbp.py:13-25 and tests/test_density_queries.py:23-49:
    P=128, 40 iterations."""
    g, (d, x1, x2) = toy.hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    eng = _run(lt.compile_graph(g, "cpu"), 128, 40, 1)
    assert np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.08
    assert abs(eng.mean(x1) - exact.mean(x1)) < 0.22
    assert abs(eng.mean(x2) - exact.mean(x2)) < 0.22
    assert abs(eng.var(x2) - exact.var(x2)) / exact.var(x2) < 0.4
    for rv in (x1, x2):
        got = eng.belief(XQ, rv)
        assert got.shape == XQ.shape
        assert np.abs(got - exact.density(XQ, rv)).max() < 0.09
        assert isinstance(eng.belief(float(XQ[0]), rv), float)
        xs = np.linspace(-8.0, 8.0, 401)
        assert abs(np.trapezoid(eng.belief(xs, rv), xs) - 1.0) < 0.05
        p, b = eng.probability(XQ, rv), eng.belief(XQ, rv)
        ratios = p[b > 1e-8] / b[b > 1e-8]
        assert ratios.max() / ratios.min() < 1.0 + 1e-6
    assert abs(eng.belief(1, d) - eng.disc_marginal(d)[1]) < 1e-12


def test_epbp_gaussian_chain_against_dense():
    """tests/test_epbp.py:28-45 and tests/test_density_queries.py:74-93:
    means within 0.25, variances within 40%, the density within 0.12 of
    the Gaussian pdf."""
    fg = _EPBP[1][2]
    g = fg.meta.graph
    eng = _run(fg, 128, 50, 0)
    dense, _ = gabp.dense_gaussian_marginals(g)
    for rv in g.rvs:
        m, v = dense[id(rv)]
        assert abs(eng.mean(rv) - m) < 0.25
        assert abs(eng.var(rv) - v) / v < 0.4
        q = m + np.sqrt(v) * np.array([-1.5, -0.5, 0.31, 1.13])
        want = np.exp(-0.5 * (q - m) ** 2 / v) / np.sqrt(2 * np.pi * v)
        assert np.abs(eng.belief(q, rv) - want).max() < 0.12


def test_epbp_large_discrete_domain_and_arity3():
    """tests/test_epbp.py:48-132: a 12-value domain at P = 64 and P = 8
    (grid axes sized per slot), and a ternary hybrid factor."""
    from lhvi_tpu_torch.potentials import (GaussianPotential, MLNPotential,
                                           TablePotential)

    d = lt.RV(lt.Domain(list(range(12))), name="d")
    x = lt.RV(lt.Domain([-8.0, 20.0], continuous=True), name="x")
    prior = np.linspace(1.0, 2.0, 12)
    g = lt.Graph([d, x], [
        lt.F(TablePotential(prior / prior.sum()), [d]),
        lt.F(GaussianPotential([4.0], [[1.0]]), [x]),
        lt.F(MLNPotential(lambda a: -0.5 * (a[1] - a[0]) ** 2, w=1.0,
                          formula_name="link"), [d, x]),
    ])
    exact = ExactPosterior(g, cont_grid=201)
    fg = lt.compile_graph(g, "cpu")
    assert fg.max_v == 12
    eng = _run(fg, 64, 40, 3)
    assert np.abs(eng.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.05
    assert abs(eng.mean(x) - exact.mean(x)) < 0.3
    eng8 = _run(fg, 8, 40, 3)
    assert np.abs(eng8.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.25
    assert abs(eng8.mean(x) - exact.mean(x)) < 1.0

    b = lt.Domain([0, 1])
    z1, z2 = lt.RV(b, name="z1"), lt.RV(b, name="z2")
    x = lt.RV(lt.Domain([-6, 6], continuous=True), name="x")
    g = lt.Graph([z1, z2, x], [
        lt.F(TablePotential([0.7, 0.3]), [z1]),
        lt.F(TablePotential([[2.0, 1.0], [1.0, 2.0]]), [z1, z2]),
        lt.F(MLNPotential(
            lambda a: -a[0] * a[1] * (a[2] - 2.0) ** 2
            - (1.0 - a[0] * a[1]) * (a[2] + 1.0) ** 2 * 0.5,
            w=0.8, formula_name="gate_mean"), [z1, z2, x]),
    ])
    exact = ExactPosterior(g, cont_grid=161)
    eng = _run(lt.compile_graph(g, "cpu"), 64, 40, 2)
    assert np.abs(eng.disc_marginal(z1) - exact.disc_marginal(z1)).max() < 0.08
    assert np.abs(eng.disc_marginal(z2) - exact.disc_marginal(z2)).max() < 0.08
    assert abs(eng.mean(x) - exact.mean(x)) < 0.3


@pytest.mark.parametrize("seed", range(3))
def test_epbp_on_random_hybrid_trees(seed):
    """tests/test_fuzz_bp.py:63-104 (P = 192, 40 iterations): P(d) within
    0.1 and every mean within 0.25 of the dense oracle."""
    from lhvi_tpu_torch.potentials import (GaussianPotential, MLNPotential,
                                           TablePotential, XYPotential)

    rng = np.random.default_rng(5000 + seed)
    n = int(rng.integers(2, 4))
    dom_c = lt.Domain([-8, 8], continuous=True)
    rvs = [lt.RV(dom_c, name=f"x{i}") for i in range(n)]
    d = lt.RV(lt.Domain([0, 1]), name="d")
    factors = [lt.F(GaussianPotential([float(rng.normal())], [[2.0]]), [rv])
               for rv in rvs]
    factors.append(lt.F(TablePotential(list(rng.uniform(0.3, 1.0, size=2))),
                        [d]))
    for a, b in _rand_tree_edges(rng, n):
        factors.append(lt.F(XYPotential(float(rng.uniform(-0.5, 0.5)), 1.5),
                            [rvs[a], rvs[b]]))
    c0 = float(rng.uniform(-1.5, 1.5))
    factors.append(lt.F(MLNPotential(lambda a: -((a[1] - c0 * a[0]) ** 2) / 4.0,
                                     w=1.0, formula_name="dx"), [d, rvs[0]]))
    g = lt.Graph(rvs + [d], factors)
    oracle = ExactPosterior(g, cont_grid=61 if n == 3 else 121)
    eng = _run(lt.compile_graph(g, "cpu"), 192, 40, seed)
    assert np.abs(eng.disc_marginal(d)[:2] - oracle.disc_marginal(d)).max() < 0.1
    for rv in rvs:
        assert abs(eng.mean(rv) - oracle.mean(rv)) < 0.25, rv.name


def test_lbp_observed_slot_wider_than_the_support():
    """A deliberate divergence (ROADMAP Queue 3): an observed discrete
    variable whose domain is wider than every latent one. The bucket's
    value tables are as wide as that domain, wider than the support
    width S; the reference's table build raises ValueError there
    (lhvi_tpu/engines/lbp.py:125), the port reads the observed slot's
    value from its own table and answers exactly."""
    def tree(dsl_rv, dsl_dom, dsl_f, dsl_g, table):
        a = dsl_rv(dsl_dom([0, 1]), name="a")
        b = dsl_rv(dsl_dom([0, 1, 2, 3]), name="b", value=3)
        t = np.array([[1.0, 2.0, 0.5, 3.0], [2.0, 1.0, 1.5, 0.25]])
        return dsl_g([a, b], [dsl_f(table([0.4, 0.6]), [a]),
                              dsl_f(table(t), [a, b])]), a

    g_ref, _ = tree(RRV, RDomain, RF, RGraph, RTable)
    with pytest.raises(ValueError):
        RefLBP(ref_compile(g_ref))
    from lhvi_tpu_torch.potentials import TablePotential

    g, a = tree(lt.RV, lt.Domain, lt.F, lt.Graph, TablePotential)
    eng = HybridLBP(lt.compile_graph(g, "cpu")).run(n_iters=4, damping=0.0)
    want = np.array([0.4 * 3.0, 0.6 * 0.25])
    np.testing.assert_allclose(eng.disc_marginal(a), want / want.sum(),
                               atol=1e-6)
