"""The port's NUTS engine held to the JAX reference and to exact oracles.
NUTS-within-Gibbs on hybrid, non-quadratic models is held to exact
enumeration (``ExactPosterior``) and closed forms.

Deterministic pieces (bit counts, the U-turn test, the gradient closures,
one lockstep transition given its uniforms) are fed the same numpy inputs
in both packages or checked for their invariances. The sampler as a whole
draws from torch generators, which cannot reproduce JAX's streams, so its
moments are held to exact Gaussian answers at the thresholds of the
reference's own tests, and one transition's depth and acceptance
statistics are compared between the packages from the same states.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines import nuts as ref_nuts  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch import Domain, F, Graph, RV  # noqa: E402
from lhvi_tpu_torch.engines import hmc, nuts  # noqa: E402
from lhvi_tpu_torch.ops import nuts_traj  # noqa: E402
from lhvi_tpu_torch.potentials import (  # noqa: E402
    GaussianPotential,
    MLNPotential,
    TablePotential,
)
from lhvi_tpu_torch.utils.metrics import counters  # noqa: E402
from lhvi_tpu_torch.utils.oracle import ExactPosterior  # noqa: E402
from test_torch_compile import _mirror, _rand_ref_graph, _states  # noqa: E402


def _corr_gaussian():
    dom = Domain([-20, 20], continuous=True)
    a, b = RV(dom, name="a"), RV(dom, name="b")
    g = Graph([a, b], [F(GaussianPotential([1.0, -2.0],
                                           [[1.0, 0.8], [0.8, 2.0]]), [a, b])])
    return lt.compile_graph(g, "cpu"), a, b


def test_popcount_ctz_match_reference():
    v = np.arange(0, 2**10 + 1, dtype=np.int32)
    want_pc = np.asarray(ref_nuts._popcount(jnp.asarray(v)))
    want_ctz = np.asarray(ref_nuts._ctz(jnp.asarray(v)))
    t = torch.from_numpy(v)
    np.testing.assert_array_equal(nuts._popcount(t).numpy(), want_pc)
    np.testing.assert_array_equal(nuts._ctz(t).numpy(), want_ctz)
    assert [nuts._popcount(int(i)) for i in v] == list(want_pc)
    assert [nuts._ctz(int(i)) for i in v] == list(want_ctz)


def test_uturn_matches_reference():
    rng = np.random.default_rng(0)
    C, n = 512, 9
    dq, pa, pb = (rng.normal(size=(C, n)).astype(np.float32) for _ in range(3))
    im = rng.uniform(0.5, 1.5, n).astype(np.float32)
    want = np.asarray(ref_nuts._uturn_batched(*map(jnp.asarray,
                                                   (dq, pa, pb, im))))
    got = nuts._uturn_batched(*map(torch.from_numpy, (dq, pa, pb, im)))
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("quad_max_n", [4096, 8])
def test_grad_lp_matches_reference(quad_max_n):
    """Dense (one product) and ELL (sparse matvec) gradient closures: the
    same q gives the same (g, lp) within 1e-6 of the values' scale."""
    g_ref, _ = ref_toy.gaussian_grid(6, 6, seed=3, evidence_frac=0.2)
    g, _ = toy.gaussian_grid(6, 6, seed=3, evidence_frac=0.2)
    rfg = ref_compile(g_ref, quad_max_n=quad_max_n)
    fg = lt.compile_graph(g, "cpu", quad_max_n=quad_max_n)
    assert fg.quad_sparse == (quad_max_n == 8) == bool(rfg.quad_sparse)
    q = (3.0 * np.random.default_rng(1).normal(size=(64, fg.n_cont))
         ).astype(np.float32)
    gr, lpr = ref_nuts._make_grad_lp(rfg, None)(jnp.asarray(q))
    gp, lpp = nuts._make_grad_lp(fg, None)(torch.from_numpy(q))
    gr, lpr = np.asarray(gr), np.asarray(lpr)
    np.testing.assert_allclose(gp.numpy(), gr, rtol=1e-6,
                               atol=1e-6 * np.abs(gr).max())
    np.testing.assert_allclose(lpp.numpy(), lpr, rtol=1e-6,
                               atol=1e-6 * np.abs(lpr).max())


def test_lockstep_uniform_table_is_deterministic_and_chainwise():
    """With a given uniforms table (and momenta) the plain version is a
    function of its inputs; permuting the chains together with the
    table's chain columns permutes the results the same way, because no
    chain's tree depends on another's."""
    g, _ = toy.gaussian_grid(4, 4, seed=1, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    C, n, D = 96, fg.n_cont, 5
    rng = np.random.default_rng(2)
    xc = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    p0 = torch.from_numpy(rng.normal(size=(C, n)).astype(np.float32))
    U = torch.from_numpy(rng.uniform(size=(3, 2**D, C)).astype(np.float32))
    im = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32))
    eps = torch.tensor(0.6)
    a = nuts._nuts_lockstep(fg, None, xc, None, eps, im, D, uniforms=U, p0=p0)
    b = nuts._nuts_lockstep(fg, None, xc, None, eps, im, D, uniforms=U, p0=p0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    depth = a[3].numpy()
    assert len(np.unique(depth)) > 1  # trees stop at different depths
    perm = torch.from_numpy(rng.permutation(C))
    c = nuts._nuts_lockstep(fg, None, xc[perm], None, eps, im, D,
                            uniforms=U[:, :, perm].contiguous(), p0=p0[perm])
    for x, y in zip(a, c):
        np.testing.assert_allclose(x[perm].numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for x, y in zip(a[2:], c[2:]):  # n_leaf, depth, diverged: exact
        assert torch.equal(x[perm], y)


def test_trajectory_routes_to_the_plain_version_on_cpu():
    """A NUTS transition on a dense target's CPU tensors is the lockstep
    loop (no kernel launch), with p0 the first draw of the generator;
    ``nuts_trajectory``, K3's wrapper, refuses CPU tensors."""
    fg, _, _ = _corr_gaussian()
    C, D = 64, 4
    xc = torch.zeros((C, 2))
    im = torch.tensor([1.0, 0.5])
    U = torch.rand((3, 2**D, C), generator=torch.Generator().manual_seed(9))
    with pytest.raises(NotImplementedError, match="CUDA tensors"):
        nuts_traj.nuts_trajectory(fg, torch.Generator(), xc, 0.3, im, D)
    before = counters()["ops.k3.launches"]
    a = nuts._nuts_sweep_batched(fg, torch.Generator().manual_seed(4), xc,
                                 None, 0.3, im, D, uniforms=U)
    gen = torch.Generator().manual_seed(4)
    p0 = nuts_traj.momentum_std(im)[None] * torch.randn((C, 2), generator=gen)
    q, sa, nl, d, dv = nuts._nuts_lockstep(fg, None, xc, None, 0.3, im, D,
                                           uniforms=U, p0=p0)
    assert counters()["ops.k3.launches"] == before
    assert torch.equal(a[0], q) and torch.equal(a[2], d)
    assert torch.equal(a[1], sa / torch.clamp(nl, min=1).float())


def test_nuts_correlated_gaussian():
    """tests/test_nuts_map.py:14-29 thresholds."""
    fg, a, b = _corr_gaussian()
    res = nuts.sample(fg, torch.Generator().manual_seed(0), n_chains=16,
                      n_warmup=300, n_samples=600)
    assert res.diag["divergence_rate"] < 0.02
    assert res.diag["mean_depth"] >= 1.0
    assert abs(res.mean(a) - 1.0) < 0.08
    assert abs(res.mean(b) + 2.0) < 0.12
    assert abs(res.var(a) - 1.0) < 0.15
    assert abs(res.var(b) - 2.0) / 2.0 < 0.15


def test_nuts_moments_and_thin():
    """tests/test_nuts_map.py:72-88: collect="moments" with thin=2."""
    fg, a, b = _corr_gaussian()
    res = nuts.sample(fg, torch.Generator().manual_seed(2), n_chains=32,
                      n_warmup=300, n_samples=400, collect="moments", thin=2)
    assert abs(res.mean(a) - 1.0) < 0.1
    assert abs(res.mean(b) + 2.0) < 0.15
    assert abs(res.var(a) - 1.0) < 0.2
    assert res.diag["divergence_rate"] < 0.02
    assert np.isfinite(res.diag["rhat"]).all()


def test_nuts_grid_matches_dense_solve():
    """A 5×5 evidence grid: moments against the dense solve of the port's
    own (J, h) (tests/test_hmc.py:60-79 thresholds)."""
    g, _ = toy.gaussian_grid(5, 5, seed=4, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    J = fg.meta.np_global["quad_J"].astype(np.float64)
    h = fg.meta.np_global["quad_h"].astype(np.float64)
    mean, var = np.linalg.solve(J, h), np.diag(np.linalg.inv(J))
    moments, _, diag = nuts.run_nuts(
        fg, torch.Generator().manual_seed(3), nuts.NUTSConfig(max_depth=6),
        n_chains=64, n_warmup=300, n_samples=400, collect="moments")
    err = np.abs(moments["mean"].numpy() - mean).mean()
    vrel = np.abs(moments["var"].numpy() / var - 1.0).mean()
    assert err < 0.08, err
    assert vrel < 0.2, vrel
    assert float(diag["divergence_rate"]) < 0.01
    assert 0.5 < float(diag["accept_rate"]) <= 1.0


def test_one_transition_statistics_match_reference():
    """One transition at a fixed step size from the same 2,048 starting
    states: mean tree depth within 0.1 and mean acceptance statistic
    within 0.02 of the reference's lockstep sweep (different momenta and
    uniforms; both are exact draws of the same transition kernel)."""
    g_ref, _ = ref_toy.gaussian_grid(5, 5, seed=4, evidence_frac=0.2)
    g, _ = toy.gaussian_grid(5, 5, seed=4, evidence_frac=0.2)
    rfg, fg = ref_compile(g_ref), lt.compile_graph(g, "cpu")
    C, n, D = 2048, fg.n_cont, 6
    J = np.asarray(rfg.quad_J, np.float64)
    mode = np.linalg.solve(J, np.asarray(rfg.quad_h, np.float64))
    rng = np.random.default_rng(5)
    xc = (mode + rng.normal(size=(C, n)) @ np.linalg.cholesky(
        np.linalg.inv(J)).T).astype(np.float32)
    im = np.ones(n, np.float32)
    eps = 0.35
    _, acc_r, depth_r, div_r = ref_nuts._nuts_sweep_batched(
        rfg, jax.random.PRNGKey(0), jnp.asarray(xc),
        jnp.zeros((C, 0), jnp.int32), jnp.float32(eps), jnp.asarray(im), D,
        use_pallas=False)
    _, acc, depth, div, _ = nuts._nuts_sweep_batched(
        fg, torch.Generator().manual_seed(0), torch.from_numpy(xc), None,
        torch.tensor(eps), torch.from_numpy(im), D)
    dr, ar = float(np.mean(np.asarray(depth_r))), float(np.mean(acc_r))
    d, a = float(depth.float().mean()), float(acc.mean())
    assert abs(d - dr) < 0.1, (d, dr)
    assert abs(a - ar) < 0.02, (a, ar)
    assert not np.asarray(div_r).any() and not div.any()


def test_out_of_slice_paths_raise():
    """Nothing is out of the slice now: a hybrid model runs
    (NUTS-within-Gibbs) and returns its discrete draws, and ``mode_swap``
    runs (without a qualifying class it warns and runs plain Gibbs)."""
    g, _ = toy.hybrid_chain()
    fg = lt.compile_graph(g, "cpu")
    gen = torch.Generator().manual_seed(0)
    s_xc, s_xd, _ = nuts.run_nuts(fg, gen, n_chains=2, n_warmup=2,
                                  n_samples=2)
    assert s_xc.shape == (2, 2, 2) and s_xd.shape == (2, 2, 1)
    fg, _, _ = _corr_gaussian()
    with pytest.warns(UserWarning, match="no-op"):
        s_xc, _, diag = nuts.run_nuts(fg, gen, nuts.NUTSConfig(mode_swap=True),
                                      n_chains=2, n_warmup=2, n_samples=2)
    assert s_xc.shape == (2, 2, 2) and "mode_swap_accept" not in diag


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grad_lp_autograd_matches_reference_vjp(seed):
    """The general branch of ``_make_grad_lp`` (autograd over
    ``log_prob_cont_batched`` at fixed discrete states) against the
    reference's ``jax.vjp`` on fuzzed hybrid graphs (the generator of
    tests/test_torch_compile.py): rtol 1e-5, atol 1e-5·max|value|, f32
    sums in another order."""
    g_ref = _rand_ref_graph(np.random.default_rng(seed))
    rfg = ref_compile(g_ref)
    fg = lt.compile_graph(_mirror(g_ref), "cpu")
    assert not fg.cont_pure_quad and fg.n_disc > 0
    xc, xd = _states(fg, np.random.default_rng(50 + seed), 16)
    gr, lpr = ref_nuts._make_grad_lp(rfg, jnp.asarray(xd))(jnp.asarray(xc))
    gp, lpp = nuts._make_grad_lp(fg, torch.from_numpy(xd).long())(
        torch.from_numpy(xc))
    for got, want in ((gp, gr), (lpp, lpr)):
        want = np.asarray(want)
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_nuts_hybrid_chain_matches_exact():
    """tests/test_nuts_map.py:32-41's thresholds: NUTS-within-Gibbs on
    hybrid_chain (the lockstep loop on the autograd gradient) within 0.1
    of the exact means and 0.06 of the exact discrete marginal; moments
    mode fills the discrete marginals and the streamed discrete R̂."""
    g, (d, x1, x2) = toy.hybrid_chain()
    exact = ExactPosterior(g, cont_grid=161)
    fg = lt.compile_graph(g, "cpu")
    res = nuts.sample(fg, torch.Generator().manual_seed(1), n_chains=256,
                      n_warmup=150, n_samples=200, collect="moments")
    assert abs(res.mean(x1) - exact.mean(x1)) < 0.1
    assert abs(res.mean(x2) - exact.mean(x2)) < 0.1
    assert np.abs(res.disc_marginal(d) - exact.disc_marginal(d)).max() < 0.06
    assert res.diag["divergence_rate"] < 0.02
    assert res.diag["disc_diag_idx"].tolist() == [0]
    assert abs(float(res.diag["rhat_disc"][0]) - 1.0) < 0.05


def test_nuts_samples_mode_on_the_verify_model():
    """The verify skill's toy model (w ∈ {0, 1}, prior (0.8, 0.2), a link
    whose normalization over t does not depend on w) in samples mode:
    P(w) within 0.03 of (0.8, 0.2) and E[t] within 0.4 of 13, the bounds
    of tests/test_torch_gibbs.py::test_samples_mode_disc_marginal."""
    w = RV(Domain([0, 1]), name="w")
    t = RV(Domain([-20, 40], continuous=True), name="t")
    g = Graph([w, t], [
        F(TablePotential([0.8, 0.2]), [w]),
        F(MLNPotential(lambda a: -((a[1] - (15.0 - 10.0 * a[0])) ** 2)
                       / 50.0, w=1.0, formula_name="link"), [w, t]),
    ])
    fg = lt.compile_graph(g, "cpu")
    res = nuts.sample(fg, torch.Generator().manual_seed(2),
                      cfg=nuts.NUTSConfig(init_step_size=0.5), n_chains=256,
                      n_warmup=150, n_samples=200)
    np.testing.assert_allclose(res.disc_marginal(w), (0.8, 0.2), atol=0.03)
    assert abs(res.mean(t) - 13.0) < 0.4


def test_samples_mode_and_config_mapping():
    """collect="samples" returns [S, C, n] draws with the reference's
    diagnostics; to_hmc carries the shared fields; the lockstep loop runs
    on a dense target on CPU tensors."""
    fg, a, _ = _corr_gaussian()
    cfg = nuts.NUTSConfig(max_depth=5, init_step_size=0.3)
    hc = cfg.to_hmc()
    assert isinstance(hc, hmc.HMCConfig) and hc.init_step_size == 0.3
    s_xc, s_xd, diag = nuts.run_nuts(fg, torch.Generator().manual_seed(1),
                                     cfg, n_chains=4, n_warmup=10,
                                     n_samples=5, thin=2)
    assert s_xc.shape == (5, 4, 2) and s_xd.shape == (5, 4, 0)
    assert set(diag) == {"accept_rate", "mean_depth", "divergence_rate",
                         "step_size", "inv_mass"}
    assert 1.0 <= float(diag["mean_depth"]) <= 5.0
    res = hmc.HMCResult(fg, s_xc, s_xd, diag)
    assert res.map(a) == res.mean(a)


# ---- K3's launch geometry (csrc/nuts_traj.cu checks what it is given) ------

_K3_SRC = Path(nuts_traj.__file__).parent / "csrc" / "nuts_traj.cu"


def _k3_const(name):
    """An integer ``constexpr`` of the kernel source, as the kernel sees it."""
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                  _K3_SRC.read_text())
    assert m, name
    return int(eval(m.group(1)))


def test_k3_launch_mirrors_the_kernel_constants():
    """The Python geometry and the launcher's checks agree on the layout
    edges, the slot counts, the block shape, the blocks an SM and the
    limits."""
    src = _K3_SRC.read_text()
    assert "n > 256 || (slots != 1 && slots != 2 && slots != 4)" in src
    assert "const int m_max = np <= 2 ? 4 : 2;" in src
    assert "return max_depth > 2 ? max_depth - 1 : 1;" in src
    assert "__launch_bounds__(kMaxWarps * 32, M * NP <= 8 ? 2 : 1)" in src
    assert _k3_const("kMaxWarps") == nuts_traj.K3_MAX_WARPS
    assert _k3_const("kBlockThreads") == nuts_traj.K3_BLOCK_THREADS
    assert _k3_const("kBlockSlots") == nuts_traj.K3_BLOCK_SLOTS
    assert _k3_const("kMaxDepth") == nuts_traj.K3_MAX_DEPTH
    assert re.search(r"\bkCk = (\d+);", src).group(1) == str(nuts_traj.K3_ROWS)
    assert _k3_const("kSmemLimit") == nuts_traj.K3_SMEM_LIMIT == 232448
    assert nuts_traj.K3_WARP_MAX_N == 256
    assert [nuts_traj.k3_blocks_per_sm(np_, M) for np_, M in
            ((1, 4), (2, 4), (3, 2), (4, 2), (5, 2), (8, 1), (3, 4))] == [
        2, 2, 2, 2, 1, 2, 1]


@pytest.mark.parametrize("max_depth", range(21))
def test_k3_launch_fits_every_n_and_depth(max_depth):
    """For n in 1..4,096 (every n to 300, then a stride) at max_depth
    0..20: the geometry fits 232,448 bytes and is the kernel's own
    reckoning; the warp layout runs exactly up to n = 256 (every depth
    fits there), 4 slots up to NP = 2, else 2, halved only where fewer
    than 4 warps would fit one block an SM; at most 12 warps, and as many
    as the blocks an SM leave room for; past 256 the block layout with the
    deepest k-tile (≤ 32 rows) whose two stages fit; grids are one wave
    and never larger than the chains need."""
    S = max_depth - 1 if max_depth > 2 else 1
    R = 5 + 2 * S
    wb = lambda n, M: -(-(16 * M + 4 * n * M + 4 * M * R * n) // 16) * 16  # noqa: E731
    bb = lambda n, kt: (2208 + 32 * n + 8 * ((kt * n + 7) // 4 * 4))  # noqa: E731
    for n in list(range(1, 301)) + list(range(301, 4097, 53)) + [4096]:
        for C in (1, 301, 65536):
            geo = nuts_traj.k3_launch(n, max_depth, C)
            assert geo.smem <= 232448
            if n <= 256:
                np_ = -(-n // 32)
                assert geo.layout == "warp" and geo.k_tile == 0
                top = 4 if np_ <= 2 else 2
                assert geo.slots in (1, 2, 4) and geo.slots <= top
                assert 1 <= geo.warps <= 12
                assert geo.smem == geo.warps * wb(n, geo.slots)
                assert geo.warps >= 4 or geo.slots == 1
                # two blocks an SM where the registers allow and 4 warps
                # fit half the SM's shared memory, else one; then the most
                # warps that fit
                two = min(12, (233472 // 2 - 1024) // wb(n, geo.slots))
                b = (2 if nuts_traj.k3_blocks_per_sm(np_, geo.slots) == 2
                     and two >= 4 else 1)
                assert geo.warps == (two if b == 2 else min(
                    12, 232448 // wb(n, geo.slots)))
                if geo.slots < top:  # twice the slots leave < 4 warps
                    assert 4 * wb(n, 2 * geo.slots) > 232448
                per = geo.warps * geo.slots
                assert 1 <= geo.grid and (geo.grid - 1) * per < C
                assert geo.grid == min(-(-C // per), 132 * b)
            else:
                assert geo.layout == "block" and geo.slots == 8
                assert geo.warps == 16
                assert geo.smem == bb(n, geo.k_tile)
                assert geo.k_tile == 32 or bb(n, geo.k_tile + 1) > 232448
                assert geo.grid == min(-(-C // 8), 132)


def test_k3_launch_at_the_bench_shapes():
    """The 10×10 grid (n = 82, max_depth 4) at 65,536 chains: 2 slots, 12
    warps, two blocks an SM; at max_depth 20 the rows leave 4 warps. The
    64×64 grid (n = 3,246) at 1,024 chains: 128 blocks of 8 chains, J in
    4-row stages."""
    assert nuts_traj.k3_launch(82, 4, 65536) == nuts_traj.K3Launch(
        "warp", 2, 12, 94848, 264, 0)
    assert nuts_traj.k3_launch(82, 20, 65536)[:3] == ("warp", 2, 4)
    assert nuts_traj.k3_launch(3246, 4, 1024) == nuts_traj.K3Launch(
        "block", 8, 16, 2208 + 32 * 3246 + 8 * 12988, 128, 4)
    assert nuts_traj.k3_launch(82, 4, 65536, sms=100).grid == 200
    for bad in ((0, 4, 5), (4097, 4, 5), (82, 21, 5), (82, -1, 5),
                (82, 4, 0)):
        with pytest.raises(ValueError):
            nuts_traj.k3_launch(*bad)
