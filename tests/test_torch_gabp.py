"""The port's Gaussian BP (``lhvi_tpu_torch/engines/gabp.py``) held to the
JAX reference (``lhvi_tpu/engines/gabp.py``) on the CPU.

The host code (information forms, the dense oracle, the edge tables) is
the reference's numpy code, so its results are EQUAL. The sweeps are
``index_add_`` segment sums against the reference's ``.at[].add``: means
and variances after the same number of sweeps agree to rtol 1e-4 (atol
1e-6 near 0). Each graph is built once in each package from one numpy
seed, or mirrored object by object (``test_torch_compile._mirror``). The
engine is also held to the dense solve at the reference tests'
thresholds (tests/test_gabp.py, tests/test_fuzz_bp.py).
"""

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import lhvi_tpu.engines.gabp as ref_gabp  # noqa: E402
import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import Domain as RDomain, F as RF, Graph as RGraph, RV as RRV  # noqa: E402
from lhvi_tpu.potentials import (  # noqa: E402
    GaussianPotential as RGauss,
    LinearGaussianPotential as RLinGauss,
    XYPotential as RXY,
)

import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch.engines import gabp  # noqa: E402

from test_fuzz_bp import _rand_tree_edges  # noqa: E402
from test_torch_compile import _mirror  # noqa: E402


def _rand_tree_ref(seed):
    """tests/test_fuzz_bp.py:107-128's random Gaussian tree, in the
    reference's classes."""
    rng = np.random.default_rng(4000 + seed)
    n = int(rng.integers(4, 9))
    dom = RDomain([-10, 10], continuous=True)
    rvs = [RRV(dom, name=f"x{i}") for i in range(n)]
    factors = [RF(RGauss([float(rng.normal())],
                         [[float(rng.uniform(0.5, 3.0))]]), [rv])
               for rv in rvs]
    for a, b in _rand_tree_edges(rng, n):
        factors.append(RF(RXY(float(rng.uniform(-0.8, 0.8)), 1.2),
                          [rvs[a], rvs[b]]))
    if rng.integers(0, 2):
        rvs[-1].value = float(rng.normal())
    return RGraph(rvs, factors), n


def _chain_ref():
    """tests/test_gabp.py:13-28's chain."""
    dom = RDomain([-20, 20], continuous=True)
    xs = [RRV(dom, name=f"x{i}") for i in range(5)]
    fs = [RF(RGauss([float(i)], [[1.0 + 0.1 * i]]), [xs[i]]) for i in range(5)]
    fs += [RF(RLinGauss(coeff=0.8, sig=2.0), [xs[i], xs[i + 1]])
           for i in range(4)]
    return RGraph(xs, fs)


def _pairs():
    """(name, reference graph, port graph, sweeps): trees, a chain and
    two grids."""
    out = []
    for seed in range(6):
        g_ref, n = _rand_tree_ref(seed)
        out.append((f"tree{seed}", g_ref, _mirror(g_ref), 4 * n))
    g_ref = _chain_ref()
    out.append(("chain5", g_ref, _mirror(g_ref), 30))
    for rows, seed, ev, iters in ((6, 1, 0.25, 120), (8, 1, 0.1, 80)):
        g_ref, _ = ref_toy.gaussian_grid(rows, rows, seed=seed,
                                         evidence_frac=ev)
        g, _ = toy.gaussian_grid(rows, rows, seed=seed, evidence_frac=ev)
        out.append((f"grid{rows}", g_ref, g, iters))
    return out


_PAIRS = _pairs()


@pytest.mark.parametrize("case", range(len(_PAIRS)),
                         ids=[p[0] for p in _PAIRS])
def test_gabp_matches_reference(case):
    """Same sweeps on the same graph: means and variances within rtol
    1e-4 of the reference's, the information form and the dense oracle
    equal."""
    _, g_ref, g, iters = _PAIRS[case]
    J_r, h_r, _ = ref_gabp.information_form(g_ref)
    J, h, _ = gabp.information_form(g)
    np.testing.assert_array_equal(J, J_r)
    np.testing.assert_array_equal(h, h_r)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = ref_gabp.GaBP(g_ref).run(iters=iters)
        eng = gabp.GaBP(g, "cpu").run(iters=iters)
    np.testing.assert_allclose(eng.mean_, ref.mean_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(eng.var_, ref.var_, rtol=1e-4, atol=1e-6)
    dense, lat = gabp.dense_gaussian_marginals(g)
    dense_r, lat_r = ref_gabp.dense_gaussian_marginals(g_ref)
    for rv, rv_r in zip(lat, lat_r):
        assert dense[id(rv)] == dense_r[id(rv_r)]


@pytest.mark.parametrize("case", range(len(_PAIRS)),
                         ids=[p[0] for p in _PAIRS])
def test_gabp_against_dense_solve(case):
    """The reference tests' thresholds against the dense solve: means and
    variances exact (rtol 1e-4) on trees and chains, means within 1e-3 on
    the walk-summable grids."""
    name, _, g, iters = _PAIRS[case]
    eng = gabp.GaBP(g, "cpu").run(iters=iters)
    dense, latents = gabp.dense_gaussian_marginals(g)
    for rv in latents:
        m, v = dense[id(rv)]
        if name.startswith("grid"):
            assert abs(eng.mean(rv) - m) < 1e-3, (rv, eng.mean(rv), m)
        else:
            np.testing.assert_allclose(eng.mean(rv), m, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(eng.var(rv), v, rtol=1e-4, atol=1e-5)
        assert eng.map(rv) == eng.mean(rv)


def test_gabp_warnings_and_queries():
    """The reference's two warnings (not diagonally dominant; not
    converged) and its query errors."""
    dom = RDomain([-10, 10], continuous=True)
    a, b = RRV(dom, name="a"), RRV(dom, name="b")
    g_ref = RGraph([a, b], [RF(RGauss([0.0, 0.0], [[1.0, 1.98], [1.98, 4.0]]),
                               [a, b])])
    g = _mirror(g_ref)
    with pytest.warns(RuntimeWarning, match="diagonally dominant"):
        gabp.GaBP(g, "cpu")
    with pytest.warns(RuntimeWarning, match="did not converge"):
        gabp.GaBP(_PAIRS[-1][2], "cpu").run(iters=1)
    obs = g.rvs[0]
    obs.value = 0.5
    eng = gabp.GaBP(g, "cpu").run(iters=5)
    with pytest.raises(ValueError):
        eng.mean(obs)


def test_gabp_scales_to_100x100_grid():
    """tests/test_gabp.py:75-96: the sparse construction of the
    10,000-variable grid and 60 sweeps give finite means."""
    g, _ = toy.gaussian_grid(rows=100, cols=100, seed=0, evidence_frac=0.1)
    eng = gabp.GaBP(g, "cpu").run(iters=60)
    assert eng.n_edges > 0 and np.isfinite(eng.mean_).all()
