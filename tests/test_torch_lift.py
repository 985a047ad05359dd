"""The port's object-graph lifting (``lhvi_tpu_torch/lift/color.py``), its
native refinement core and coarse-to-fine VI (``infer_c2f``) held to the
JAX reference.

Colour partitions are exact: the port's, on the Python and the native
backend, equal the reference's (RVs matched by name, factors by position).
The lifting invariant (lifted ELBO with orbit-tied parameters = grounded
ELBO with those parameters broadcast) holds at the reference's tolerances
(rtol 1e-4, atol 1e-3; 2e-3 on the fuzzed copies). The rest are the
reference's tests/test_lift.py, test_fuzz_lift.py, test_native.py and the
object-path cases of test_c2f.py on the port, at their thresholds.
"""

import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from lhvi_tpu.lift.color import color_refine as ref_color_refine  # noqa: E402
from lhvi_tpu.models.relational import friends_smokers as ref_fs  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
from lhvi_tpu_torch import Domain, F, Graph, RV  # noqa: E402
from lhvi_tpu_torch.engines import vi  # noqa: E402
from lhvi_tpu_torch.lift import color_refine, compile_lifted, lifting_report  # noqa: E402
from lhvi_tpu_torch.models.relational import friends_smokers  # noqa: E402
from lhvi_tpu_torch.native import load_fastlift  # noqa: E402
from lhvi_tpu_torch.potentials import (  # noqa: E402
    GaussianPotential,
    LinearGaussianPotential,
    XYPotential,
)
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

from test_fuzz_compile import _rand_graph  # noqa: E402
from test_fuzz_lift import _k_copies  # noqa: E402
from test_lift import star_graph as ref_star_graph  # noqa: E402
from test_torch_compile import _mirror  # noqa: E402


def star_graph(n_leaves=5):
    """Centre variable with n symmetric leaves: the leaves form one orbit."""
    dom = Domain([-10, 10], continuous=True)
    center = RV(dom, name="center")
    leaves = [RV(dom, name=f"leaf{i}") for i in range(n_leaves)]
    fs = [F(GaussianPotential([0.0], [[1.0]]), [center])]
    for lf in leaves:
        fs.append(F(LinearGaussianPotential(1.0, 2.0), [center, lf]))
        fs.append(F(GaussianPotential([1.0], [[2.0]]), [lf]))
    return Graph([center] + leaves, fs), center, leaves


def _partitions(g, colors):
    """(RV partition by name, factor partition by position) of a colouring."""
    rvc, fc = colors
    rv_groups, f_groups = {}, {}
    for rv in g.rvs:
        rv_groups.setdefault(rvc[id(rv)], set()).add(rv.name)
    for i, f in enumerate(g.factors):
        f_groups.setdefault(fc[id(f)], set()).add(i)
    return ({frozenset(s) for s in rv_groups.values()},
            {frozenset(s) for s in f_groups.values()})


def _fs7():
    """friends_smokers(7) with two observations, in either package."""
    def build(fs):
        rg = fs(n_people=7, hybrid=True)
        rg.observe("smokes", ("p0",), 1)
        rg.observe("cancer", ("p3",), 0)
        return rg.ground()[0]
    return build(ref_fs), build(friends_smokers)


def _star_pair():
    g_ref, _, leaves = ref_star_graph(6)
    leaves[0].value = 2.0  # break one leaf's symmetry
    return g_ref, _mirror(g_ref)


def _copies_pair(seed):
    g_ref = _k_copies(_rand_graph(np.random.default_rng(2000 + seed)), 3)
    return g_ref, _mirror(g_ref)


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("case", ["star", "friends7", "copies0", "copies1"])
def test_partitions_equal_reference(case, backend):
    """Both backends give the reference's partitions, rounds truncated or
    at the fixpoint."""
    g_ref, g = (_star_pair() if case == "star" else _fs7()
                if case == "friends7" else _copies_pair(int(case[-1])))
    for rounds in (0, 1, 10_000):
        want = _partitions(g_ref, ref_color_refine(
            g_ref, max_rounds=rounds, backend="python"))
        got = _partitions(g, color_refine(g, max_rounds=rounds,
                                          backend=backend))
        assert got == want, (case, backend, rounds)


def test_color_refine_rejects_unknown_backend():
    g, _, _ = star_graph(3)
    with pytest.raises(ValueError):
        color_refine(g, backend="gpu")


# --- the reference's tests/test_lift.py on the port -----------------------


def test_color_refine_star():
    g, center, leaves = star_graph(5)
    rvc, fc = color_refine(g)
    leaf_colors = {rvc[id(lf)] for lf in leaves}
    assert len(leaf_colors) == 1
    assert rvc[id(center)] not in leaf_colors
    rep = lifting_report(g)
    assert rep["n_rv_orbits"] == 2
    assert rep["n_factor_orbits"] == 3  # center prior, couplings, leaf priors


def test_color_refine_breaks_symmetry_on_evidence():
    g, center, leaves = star_graph(5)
    leaves[0].value = 3.0
    rep = lifting_report(g)
    assert rep["n_rv_orbits"] == 3
    assert rep["n_factor_orbits"] == 5


def test_asymmetric_argument_order_not_merged():
    """Factors whose args appear in different positions must not merge."""
    dom = Domain([-10, 10], continuous=True)
    a, b = RV(dom, "a"), RV(dom, "b")
    g = Graph([a, b], [
        F(LinearGaussianPotential(2.0, 1.0), [a, b]),
        F(GaussianPotential([0.0], [[1.0]]), [a]),
        F(GaussianPotential([0.0], [[1.0]]), [b]),
    ])
    rvc, _ = color_refine(g)
    assert rvc[id(a)] != rvc[id(b)]


def _broadcast(fg_l, fg_g, g, p_l, K):
    """Lifted params broadcast to the grounded slots."""
    gather_c = np.zeros(fg_g.n_cont, np.int64)
    gather_d = np.zeros(fg_g.n_disc, np.int64)
    for rv in g.rvs:
        if rv.value is not None:
            continue
        kind_g, i_g = fg_g.meta.loc(rv)
        kind_l, i_l = fg_l.meta.loc(rv)
        assert kind_g == kind_l
        (gather_c if kind_g == "c" else gather_d)[i_g] = i_l
    return vi.VIParams(
        log_w=p_l.log_w,
        mu=p_l.mu[:, gather_c] if fg_g.n_cont else torch.zeros((K, 0)),
        log_sigma=(p_l.log_sigma[:, gather_c] if fg_g.n_cont
                   else torch.zeros((K, 0))),
        logits=(p_l.logits[:, gather_d] if fg_g.n_disc
                else torch.zeros((K, 0, fg_g.max_v))),
    )


def test_lifted_elbo_equals_grounded_elbo():
    """ELBO(lifted IR, tied params) == ELBO(grounded IR, broadcast)."""
    g, _, _ = star_graph(6)
    fg_l = compile_lifted(g, "cpu")
    fg_g = lt.compile_graph(g, "cpu")
    assert fg_l.n_cont == 2 and fg_g.n_cont == 7
    cfg = vi.VIConfig(K=3)
    p_l = vi.init_params(fg_l, torch.Generator().manual_seed(0), cfg)
    p_g = _broadcast(fg_l, fg_g, g, p_l, cfg.K)
    e_l = float(vi.elbo(fg_l, p_l, n_quad=7))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=7))
    assert np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3), (e_l, e_g)


def test_friends_smokers_lifted_vi_vs_exact():
    """Small non-hybrid instance: lifted VI marginals against enumeration
    (weak couplings keep the posterior effectively unimodal)."""
    rg = friends_smokers(n_people=3, hybrid=False,
                         w_smokes_cancer=0.7, w_friends=0.4)
    g, index = rg.ground()
    exact = ExactPosterior(g)
    fg_l = compile_lifted(g, "cpu")
    res = vi.infer(fg_l, torch.Generator().manual_seed(0),
                   vi.VIConfig(K=2, n_iters=1500, lr=5e-2))
    for key in [("smokes", ("p0",)), ("cancer", ("p0",)),
                ("friends", ("p0", "p1"))]:
        rv = index[key]
        err = np.abs(res.disc_marginal(rv) - exact.disc_marginal(rv)).max()
        assert err < 0.1, (key, res.disc_marginal(rv), exact.disc_marginal(rv))


def test_friends_smokers_compression():
    rg = friends_smokers(n_people=8, hybrid=True)
    g, _ = rg.ground()
    rep = lifting_report(g)
    assert rep["n_rv_orbits"] <= 4
    assert rep["n_factor_orbits"] <= 5
    assert rep["n_rvs"] >= 8 * 3

    fg_l = compile_lifted(g, "cpu")
    fg_g = lt.compile_graph(g, "cpu")
    n_lift = sum(int((b.scale > 0).sum()) for b in fg_l.buckets)
    n_ground = sum(int((b.scale > 0).sum()) for b in fg_g.buckets)
    assert n_lift * 5 < n_ground

    res = vi.infer(fg_l, torch.Generator().manual_seed(0),
                   vi.VIConfig(K=2, n_iters=400, lr=5e-2))
    assert res.trace[-1] > res.trace[0]
    assert np.isfinite(res.trace[-1])
    assert fg_l.meta.orbit_of is not None


def test_lifted_elbo_equals_grounded_elbo_tied_slots():
    """A 3-cycle of exchangeable continuous RVs with XY couplings puts both
    slots of every coupling on one orbit slot: tied factors must take the
    unfused quadrature path."""
    dom = Domain([-10, 10], continuous=True)
    xs = [RV(dom, name=f"x{i}") for i in range(3)]
    fs = [F(GaussianPotential([0.0], [[1.0]]), [x]) for x in xs]
    for i in range(3):
        fs.append(F(XYPotential(0.3, 1.0), [xs[i], xs[(i + 1) % 3]]))
    g = Graph(xs, fs)
    fg_l = compile_lifted(g, "cpu")
    fg_g = lt.compile_graph(g, "cpu")
    assert fg_l.n_cont == 1 and fg_g.n_cont == 3
    cfg = vi.VIConfig(K=2)
    p_l = vi.init_params(fg_l, torch.Generator().manual_seed(1), cfg)
    p_g = _broadcast(fg_l, fg_g, g, p_l, cfg.K)
    e_l = float(vi.elbo(fg_l, p_l, n_quad=9))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=9))
    assert np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3), (e_l, e_g)


# --- tests/test_fuzz_lift.py ----------------------------------------------


@pytest.mark.parametrize("seed", range(8))
def test_lifted_elbo_equals_grounded_on_copied_graphs(seed):
    """k exchangeable copies of a random hybrid graph compress at least
    k-fold, and the lifted ELBO equals the grounded one."""
    rng = np.random.default_rng(2000 + seed)
    base = _rand_graph(rng)
    k = int(rng.integers(2, 5))
    g = _mirror(_k_copies(base, k))

    fg_g = lt.compile_graph(g, "cpu")
    fg_l = compile_lifted(g, "cpu")
    n_lat_g = fg_g.n_cont + fg_g.n_disc
    n_lat_l = fg_l.n_cont + fg_l.n_disc
    if n_lat_g:
        assert n_lat_l * k <= n_lat_g

    cfg = vi.VIConfig(K=3)
    p_l = vi.init_params(fg_l, torch.Generator().manual_seed(seed), cfg)
    p_g = _broadcast(fg_l, fg_g, g, p_l, cfg.K)
    e_l = float(vi.elbo(fg_l, p_l, n_quad=7))
    e_g = float(vi.elbo(fg_g, p_g, n_quad=7))
    np.testing.assert_allclose(e_l, e_g, rtol=1e-4, atol=2e-3)


# --- tests/test_native.py -------------------------------------------------


def _same_partition(g, a, b):
    assert _partitions(g, a) == _partitions(g, b)


def test_native_matches_python_star():
    g, center, leaves = star_graph(6)
    leaves[0].value = 2.0
    _same_partition(g, color_refine(g, backend="python"),
                    color_refine(g, backend="native"))


def test_native_matches_python_relational():
    g = _fs7()[1]
    _same_partition(g, color_refine(g, backend="python"),
                    color_refine(g, backend="native"))


def test_native_large_graph_fast():
    """100 people: over 20,000 edges, so "auto" takes the native core."""
    load_fastlift()  # the build is not part of the timing
    g, _ = friends_smokers(n_people=100, hybrid=True).ground()
    assert sum(len(f.nb) for f in g.factors) >= 20_000
    t0 = time.time()
    rvc, fc = color_refine(g, backend="native")
    dt = time.time() - t0
    assert len(set(rvc.values())) == 4
    assert dt < 2.0, f"native refinement too slow: {dt:.2f}s"
    _same_partition(g, (rvc, fc), color_refine(g))


# --- the object-path cases of tests/test_c2f.py ---------------------------


def _small_mln():
    rg = friends_smokers(n_people=3, hybrid=False,
                         w_smokes_cancer=0.7, w_friends=0.4)
    rg.observe("smokes", ("p0",), 1)
    return rg


def test_c2f_matches_exact_on_small_mln():
    g, index = _small_mln().ground()
    exact = ExactPosterior(g)
    res = vi.infer_c2f(g, 0, vi.VIConfig(K=2, n_iters=2400, lr=5e-2),
                       schedule=(0, None, "ground"), device="cpu")
    assert len(res.trace) == 2400
    for key in [("cancer", ("p0",)), ("smokes", ("p1",))]:
        rv = index[key]
        err = np.abs(res.disc_marginal(rv) - exact.disc_marginal(rv)).max()
        assert err < 0.1, (key, res.disc_marginal(rv), exact.disc_marginal(rv))


def test_c2f_stage_partitions_refine():
    """Truncated refinement gives coarser partitions than the fixpoint."""
    rg = friends_smokers(n_people=6, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g, _ = rg.ground()
    n0 = compile_lifted(g, "cpu", max_rounds=0).n_disc
    nf = compile_lifted(g, "cpu").n_disc
    ng = sum(1 for rv in g.rvs if not rv.observed and not rv.domain.continuous)
    assert n0 <= nf <= ng
    assert n0 < ng


def test_c2f_final_stage_is_grounded():
    rg = friends_smokers(n_people=4, hybrid=True)
    g, index = rg.ground()
    res = vi.infer_c2f(g, 1, vi.VIConfig(K=2, n_iters=600),
                       schedule=(None, "ground"), device="cpu")
    n_lat_disc = sum(
        1 for rv in g.rvs if not rv.observed and not rv.domain.continuous)
    assert res.fg.n_disc == n_lat_disc
    assert np.isfinite(res.trace).all()
    p = res.disc_marginal(index[("smokes", ("p2",))])
    assert abs(p.sum() - 1.0) < 1e-5


def test_c2f_transfer_keeps_the_lifted_elbo():
    """Carrying fitted lifted parameters to the grounded graph leaves the
    ELBO unchanged (the C2F warm start loses nothing)."""
    g, _ = _small_mln().ground()
    fg_l = compile_lifted(g, "cpu")
    fg_g = lt.compile_graph(g, "cpu")
    cfg = vi.VIConfig(K=2, n_iters=100, n_quad=7)
    p_l, _ = vi.fit(fg_l, torch.Generator().manual_seed(4), cfg)
    p_g = vi._transfer_params(fg_l, fg_g, p_l)
    e_l = float(vi.elbo(fg_l, p_l, 7))
    e_g = float(vi.elbo(fg_g, p_g, 7))
    assert np.isclose(e_l, e_g, rtol=1e-4, atol=1e-3), (e_l, e_g)


def test_c2f_empty_schedule_raises():
    g, _ = _small_mln().ground()
    with pytest.raises(ValueError):
        vi.infer_c2f(g, 0, vi.VIConfig(K=2, n_iters=20), schedule=(),
                     device="cpu")
