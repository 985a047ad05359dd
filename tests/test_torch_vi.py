"""The port's VI engine (``lhvi_tpu_torch/engines/vi.py``) held to the JAX
reference.

The same graph compiles in both packages (built from the same seed by each
package's model function, or mirrored object by object from a reference
graph) and both compute from the same parameters: drawn with numpy, or the
reference's carried across with ``vi_params_from_numpy``. The ELBO is a sum
of f32 terms taken in another order, so it agrees to rtol 1e-5; each
gradient leaf to 1e-4 × (1 + its largest magnitude); a 200-step Adam fit
from identical parameters tracks the reference's ELBO trace within rtol
1e-4, atol 1e-3 at every step. The rest are the reference's own VI tests
(closed forms, ``ExactPosterior``) on the port, at their thresholds.
"""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines import vi as ref_vi  # noqa: E402
from lhvi_tpu.lift import compile_lifted as ref_lifted  # noqa: E402
from lhvi_tpu.models.relational import friends_smokers as ref_fs  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch import Domain, F, Graph, RV  # noqa: E402
from lhvi_tpu_torch.engines import vi  # noqa: E402
from lhvi_tpu_torch.lift import compile_lifted  # noqa: E402
from lhvi_tpu_torch.models.relational import friends_smokers  # noqa: E402
from lhvi_tpu_torch.potentials import GaussianPotential, TablePotential  # noqa: E402
from lhvi_tpu_torch.utils.convert import vi_params_from_numpy  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402

from test_torch_compile import _mirror, _rand_ref_graph  # noqa: E402


def _flagship(fs, lifted, device=None):
    """The ``__graft_entry__`` model: friends_smokers(16, hybrid) with
    smokes(p0) = 1, lifted."""
    rg = fs(n_people=16, hybrid=True)
    rg.observe("smokes", ("p0",), 1)
    g, _ = rg.ground()
    return lifted(g) if device is None else lifted(g, device)


def _pair(name):
    """(reference CompiledFG, port CompiledFG on the CPU, K, n_quad)."""
    if name.startswith("rand"):
        g_ref = _rand_ref_graph(np.random.default_rng(int(name[4:])))
        return ref_compile(g_ref), lt.compile_graph(_mirror(g_ref), "cpu"), 3, 7
    if name == "hybrid_chain":
        return (ref_compile(ref_toy.hybrid_chain()[0]),
                lt.compile_graph(toy.hybrid_chain()[0], "cpu"), 4, 9)
    if name == "grid10":
        args = dict(seed=0, evidence_frac=0.2)
        return (ref_compile(ref_toy.gaussian_grid(10, 10, **args)[0]),
                lt.compile_graph(toy.gaussian_grid(10, 10, **args)[0], "cpu"),
                8, 9)
    if name == "grid32_ell":  # the sparse (ELL) information form
        args = dict(seed=0, evidence_frac=0.2)
        return (ref_compile(ref_toy.gaussian_grid(32, 32, **args)[0],
                            quad_max_n=256),
                lt.compile_graph(toy.gaussian_grid(32, 32, **args)[0], "cpu",
                                 quad_max_n=256), 3, 9)
    assert name == "flagship16"
    return (_flagship(ref_fs, ref_lifted),
            _flagship(friends_smokers, compile_lifted, "cpu"), 4, 7)


def _rand_params(fg, K, rng):
    """Numpy parameters away from any symmetric point."""
    return {
        "log_w": rng.normal(0.0, 0.5, K),
        "mu": rng.normal(0.0, 1.0, (K, fg.n_cont)),
        "log_sigma": rng.normal(-0.3, 0.3, (K, fg.n_cont)),
        "logits": rng.normal(0.0, 1.0, (K, fg.n_disc, fg.max_v)),
    }


def _ref_params(arrays):
    return ref_vi.VIParams(**{k: jnp.asarray(v, jnp.float32)
                              for k, v in arrays.items()})


def _grads(ref, fg, n_quad, arrays, dtype):
    """(reference ELBO, its gradient leaves, port ELBO, its gradient
    leaves), both packages computing in ``dtype`` from ``arrays``."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_vi.elbo(ref, p, n_quad)))(
        ref_vi.VIParams(**{k: jnp.asarray(v, jdt) for k, v in arrays.items()}))
    leaves = [torch.tensor(np.asarray(arrays[k], dtype), requires_grad=True)
              for k in vi.VIParams._fields]
    got = vi.elbo(fg, vi.VIParams(*leaves), n_quad)
    got.backward()
    got = got.detach()
    got_g = [np.zeros(np.shape(w)) if t.grad is None else t.grad.numpy()
             for t, w in zip(leaves, want_g)]
    return float(want), [np.asarray(w) for w in want_g], float(got), got_g


def _check(name, want, want_g, got, got_g):
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    for field, g, wg in zip(vi.VIParams._fields, got_g, want_g):
        tol = 1e-4 * (1.0 + np.abs(wg).max(initial=0.0))
        assert np.abs(g - wg).max(initial=0.0) <= tol, (name, field)


@pytest.mark.parametrize("name", ["hybrid_chain", "grid10", "grid32_ell",
                                  "flagship16"])
def test_elbo_and_gradient_match_reference(name):
    """Identical parameters in f32: ELBO within rtol 1e-5, every gradient
    leaf within 1e-4·(1 + max |reference leaf|)."""
    ref, fg, K, n_quad = _pair(name)
    arrays = _rand_params(fg, K, np.random.default_rng(11))
    _check(name, *_grads(ref, fg, n_quad, arrays, np.float32))


def _as_f64(fg):
    """The port's compiled graph with every float table in f64."""
    def conv(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return v.double()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v

    buckets = tuple(dataclasses.replace(b, **{
        f.name: conv(getattr(b, f.name)) for f in dataclasses.fields(b)})
        for b in fg.buckets)
    return dataclasses.replace(fg, buckets=buckets, vi_plans={}, **{
        f.name: conv(getattr(fg, f.name)) for f in dataclasses.fields(fg)
        if f.name not in ("buckets", "vi_plans")})


@pytest.mark.parametrize("seed", range(4))
def test_elbo_and_gradient_match_reference_random_graphs(seed):
    """``_rand_ref_graph``'s random hybrid graphs, whose hard MLN constraint
    (penalty 1e6) makes the log-scale gradient a cancellation of terms of
    order 1e5: there either package's f32 gradient lies up to 1.5e-3 from
    its f64 value, beyond 1e-4·(1 + max). So the f32 ELBO is held at rtol
    1e-5, and the ELBO and every gradient leaf at the same bounds with
    both packages computing in f64 (the quadrature nodes and weights stay
    f32 in both, as their grids are built)."""
    name = f"rand{seed}"
    ref, fg, K, n_quad = _pair(name)
    arrays = _rand_params(fg, K, np.random.default_rng(11))
    want, _, got, _ = _grads(ref, fg, n_quad, arrays, np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    jax.config.update("jax_enable_x64", True)
    try:
        out = _grads(ref, _as_f64(fg), n_quad, arrays, np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert out[1][2].dtype == np.float64 and out[3][2].dtype == np.float64
    _check(name, *out)


def _ref_init(ref, fg, K, n_quad, seed):
    """The reference's initial parameters as numpy arrays."""
    cfg = ref_vi.VIConfig(K=K, n_quad=n_quad)
    p = ref_vi.init_params(ref, jax.random.PRNGKey(seed), cfg)
    return {k: np.asarray(v) for k, v in p._asdict().items()}


@pytest.mark.parametrize("name", ["flagship16", "hybrid_chain"])
def test_fit_tracks_reference_trace(name):
    """Adam from identical parameters: the port's 200-step ELBO trace
    against the reference's at every step, rtol 1e-4, atol 1e-3."""
    ref, fg, K, n_quad = _pair(name)
    arrays = _ref_init(ref, fg, K, n_quad, 3)
    _, want = ref_vi._fit_from(ref, _ref_params(arrays),
                               ref_vi.VIConfig(K=K, n_quad=n_quad, n_iters=200))
    params, got = vi._fit_from(fg, vi_params_from_numpy(arrays, "cpu"),
                               vi.VIConfig(K=K, n_quad=n_quad, n_iters=200))
    assert got.shape == (200,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-3)
    assert all(not p.requires_grad for p in params)


def test_result_queries_match_reference():
    """``VIResult`` at identical parameters: mean, var, disc_marginal,
    belief (density and pmf) and map (mixture mode and argmax value) to
    f32 rounding."""
    ref, fg, K, _ = _pair("hybrid_chain")
    arrays = _rand_params(fg, K, np.random.default_rng(5))
    want = ref_vi.VIResult(ref, _ref_params(arrays))
    got = vi.VIResult(fg, vi_params_from_numpy(arrays, "cpu"))
    rd, rx1, _ = ref.meta.graph.rvs
    d, x1, _ = fg.meta.graph.rvs
    for q in ("mean", "var", "map"):
        np.testing.assert_allclose(getattr(got, q)(x1), getattr(want, q)(rx1),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.disc_marginal(d), want.disc_marginal(rd),
                               atol=1e-6)
    assert got.map(d) == want.map(rd)
    np.testing.assert_allclose(got.belief(0.3, x1), want.belief(0.3, rx1),
                               rtol=1e-5)
    np.testing.assert_allclose(got.belief(1, d), want.belief(1, rd), rtol=1e-5)


def test_init_params_shapes_and_values():
    fg = _pair("hybrid_chain")[1]
    cfg = vi.VIConfig(K=5, init_sigma=0.7)
    p = vi.init_params(fg, torch.Generator().manual_seed(0), cfg)
    assert p.log_w.shape == (5,) and float(p.log_w.abs().max()) == 0.0
    assert p.mu.shape == p.log_sigma.shape == (5, fg.n_cont)
    assert p.logits.shape == (5, fg.n_disc, fg.max_v)
    np.testing.assert_allclose(p.log_sigma.numpy(), np.log(0.7), rtol=1e-6)
    # spread: mid ± seed_spread·min(span, 4)/4 standard deviations
    assert float(p.mu.abs().max()) < 5.0


# --- the reference's tests/test_vi.py on the port -------------------------


def test_elbo_analytic_gaussian():
    """K=1 ELBO on a 1D Gaussian target has a closed form, evaluated
    exactly by quadrature."""
    dom = Domain([-10, 10], continuous=True)
    x = RV(dom, name="x")
    s0 = 2.0
    g = Graph([x], [F(GaussianPotential([0.0], [[s0**2]]), [x])])
    fg = lt.compile_graph(g, "cpu")

    mu, sigma = 0.7, 1.3
    params = vi.VIParams(
        log_w=torch.zeros(1),
        mu=torch.tensor([[mu]]),
        log_sigma=torch.tensor([[np.log(sigma)]], dtype=torch.float32),
        logits=torch.zeros((1, 0, 1)),
    )
    got = float(vi.elbo(fg, params, n_quad=9))
    e_term = -0.5 * np.log(2 * np.pi * s0**2) - (sigma**2 + mu**2) / (2 * s0**2)
    h_term = 0.5 * np.log(2 * np.pi * np.e) + np.log(sigma)
    assert np.isclose(got, e_term + h_term, rtol=1e-4, atol=1e-4)


def test_vi_gaussian_recovers_target():
    """K=1 VI on a Gaussian target: the optimum is the target itself."""
    dom = Domain([-10, 10], continuous=True)
    x = RV(dom, name="x")
    g = Graph([x], [F(GaussianPotential([1.5], [[0.49]]), [x])])
    fg = lt.compile_graph(g, "cpu")
    res = vi.infer(fg, torch.Generator().manual_seed(0),
                   vi.VIConfig(K=1, n_iters=1200, lr=5e-2))
    assert abs(res.mean(x) - 1.5) < 0.02
    assert abs(np.sqrt(res.var(x)) - 0.7) < 0.03


def test_vi_hybrid_chain_marginals():
    g, (d, x1, x2) = toy.hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = lt.compile_graph(g, "cpu")
    res = vi.infer(fg, torch.Generator().manual_seed(1),
                   vi.VIConfig(K=8, n_iters=2000, lr=5e-2))
    t = res.trace
    assert t[-1] > t[0]
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.15
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.15
    pd = res.disc_marginal(d)
    assert np.abs(pd - exact.disc_marginal(d)).max() < 0.08
    assert res.var(x1) > 0.5 * exact.var(x1)


def test_vi_pure_discrete():
    """VI on a 2-var discrete chain matches enumeration."""
    dom = Domain([0, 1])
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph(
        [a, b],
        [
            F(TablePotential([0.2, 0.8]), [a]),
            F(TablePotential([[2.0, 1.0], [1.0, 2.0]]), [a, b]),
        ],
    )
    exact = ExactPosterior(g)
    fg = lt.compile_graph(g, "cpu")
    res = vi.infer(fg, torch.Generator().manual_seed(2),
                   vi.VIConfig(K=4, n_iters=1500))
    for rv in (a, b):
        err = np.abs(res.disc_marginal(rv) - exact.disc_marginal(rv)).max()
        assert err < 0.08, (res.disc_marginal(rv), exact.disc_marginal(rv))


def test_vi_map_is_mixture_mode_not_component_heuristic():
    """Overlapping equal components: the mode lies between the means;
    separated unequal ones: the tallest mean; skewed overlap: the true
    density argmax."""
    x = RV(Domain([-10, 10], continuous=True), name="x")
    g = Graph([x], [F(GaussianPotential([0.0], [[1.0]]), [x])])
    fg = lt.compile_graph(g, "cpu")

    def params(w, mu, s):
        return vi.VIParams(
            log_w=torch.log(torch.tensor(w)),
            mu=torch.tensor(mu)[:, None],
            log_sigma=torch.log(torch.tensor(s))[:, None],
            logits=torch.zeros((len(w), 0, 1)),
        )

    res = vi.VIResult(fg, params([0.5, 0.5], [-0.5, 0.5], [1.0, 1.0]))
    assert abs(res.map(x)) < 1e-3, res.map(x)
    res2 = vi.VIResult(fg, params([0.7, 0.3], [-3.0, 3.0], [0.5, 0.5]))
    assert abs(res2.map(x) - (-3.0)) < 1e-3, res2.map(x)
    res3 = vi.VIResult(fg, params([0.35, 0.65], [0.0, 1.2], [0.4, 1.0]))
    grid = np.linspace(-4, 6, 200001)
    w = np.array([0.35, 0.65]); mu = np.array([0.0, 1.2]); s = np.array([0.4, 1.0])
    dens = (w[:, None] * np.exp(-0.5 * ((grid[None] - mu[:, None]) / s[:, None]) ** 2)
            / (s[:, None] * np.sqrt(2 * np.pi))).sum(0)
    assert abs(res3.map(x) - grid[dens.argmax()]) < 2e-3
