"""The port's HMC engine held to the JAX reference and to exact oracles.

Deterministic pieces (dual averaging, Welford, mass refresh, streamed
diagnostics, one transition from given momenta and uniforms) are fed the
same numpy inputs in both packages and agree to f32 rounding. The sampler
as a whole draws from torch generators, which cannot reproduce JAX's
streams, so its moments are held to the exact Gaussian oracle within
Monte Carlo error, at the thresholds the reference's own tests use.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lhvi_tpu.models.toy as ref_toy  # noqa: E402
from lhvi_tpu import compile_graph as ref_compile  # noqa: E402
from lhvi_tpu.engines import gabp  # noqa: E402
from lhvi_tpu.engines import hmc as ref_hmc  # noqa: E402
from lhvi_tpu.ops import dia as ref_dia  # noqa: E402
from lhvi_tpu.ops.leapfrog import quad_leapfrog as ref_quad_leapfrog  # noqa: E402
from lhvi_tpu.utils.diagnostics import split_rhat  # noqa: E402

import lhvi_tpu_torch as lt  # noqa: E402
import lhvi_tpu_torch.models.toy as toy  # noqa: E402
from lhvi_tpu_torch.engines import hmc  # noqa: E402
from lhvi_tpu_torch.ops.dia import dia_hmc_proposal  # noqa: E402
from lhvi_tpu_torch.utils.convert import hmc_state_from_numpy  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _state_np(state):
    return {k: np.array(v) for k, v in state._asdict().items()}


def _assert_state_close(got, want, rtol=1e-6):
    for k in hmc.HMCState._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)), rtol=rtol,
                                   atol=1e-7, err_msg=k)


@pytest.fixture(scope="module")
def grid10():
    g_ref, _ = ref_toy.gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    g, _ = toy.gaussian_grid(10, 10, seed=0, evidence_frac=0.2)
    return ref_compile(g_ref), lt.compile_graph(g, "cpu")


def test_adaptation_updates_match_reference(grid10):
    """Dual averaging, batched Welford and the mass refresh: identical
    inputs, f32 results within rtol 1e-6."""
    ref_fg, fg = grid10
    cfg_r = ref_hmc.HMCConfig(init_step_size=0.12)
    cfg = hmc.HMCConfig(init_step_size=0.12)
    rs = ref_hmc.init_hmc_state(ref_fg, jax.random.PRNGKey(0), cfg_r, 32)
    st = hmc_state_from_numpy(_state_np(rs), "cpu")
    _assert_state_close(st, rs, rtol=0)
    rng = np.random.default_rng(0)
    for i in range(12):
        acc = float(rng.uniform(0.3, 1.0))
        xc = rng.normal(size=(32, fg.n_cont)).astype(np.float32)
        rs = ref_hmc._welford_update(
            ref_hmc._da_update(rs, jnp.float32(acc), cfg_r), jnp.asarray(xc))
        st = hmc._welford_update(
            hmc._da_update(st, torch.tensor(acc), cfg), torch.from_numpy(xc))
        _assert_state_close(st, rs)
    _assert_state_close(hmc._mass_refresh(fg, cfg, st),
                        ref_hmc._mass_refresh(ref_fg, cfg_r, rs))


def test_stream_diag_matches_reference():
    """Streamed split-R̂ / AR(1) ESS / batch-means ESS from the same draws
    (odd S: the tail draw belongs to neither half) agree to rtol 1e-5, and
    the streamed R̂ equals split-R̂ on the materialized draws."""
    S, C, n = 41, 4, 3
    rng = np.random.default_rng(7)
    draws = np.cumsum(rng.normal(size=(S, C, n)), axis=0).astype(np.float32)
    draws = (0.2 * draws + rng.normal(size=(S, C, n))).astype(np.float32)
    half = S // 2
    bm_len, nb = hmc._bm_schedule(S)
    assert (bm_len, nb) == ref_hmc._bm_schedule(S)
    sd_r = ref_hmc._stream_diag_init(C, n)
    sd = hmc._stream_diag_init(C, n, "cpu")
    ref_update = jax.jit(ref_hmc._stream_diag_update,
                         static_argnums=(3, 4, 5))
    for t in range(S):
        sd_r = ref_update(sd_r, jnp.int32(t), jnp.asarray(draws[t]), half,
                          bm_len, nb)
        sd = hmc._stream_diag_update(sd, t, torch.from_numpy(draws[t]), half,
                                     bm_len, nb)
    out_r = ref_hmc._stream_diag_finalize(sd_r, S, bm_len)
    out = hmc._stream_diag_finalize(sd, S, bm_len)
    for k in ("rhat", "ess_proxy", "ess_bm"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(out_r[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(out["rhat"].numpy(),
                               np.asarray(split_rhat(jnp.asarray(draws))),
                               rtol=1e-5)


def _ref_quad_step(fg, xc, p0, u, eps, im, n_leapfrog):
    """The reference's dense/ELL proposal (hmc.py:626-655) with the
    momenta and uniforms given instead of drawn."""
    ke = lambda p: 0.5 * jnp.sum(im[None, :] * p * p, axis=-1)  # noqa: E731
    x1, p1 = ref_quad_leapfrog(xc, p0, fg.quad_J, fg.quad_h, im, eps,
                               n_leapfrog)
    h0 = -fg.quad_log_prob_batched(xc) + ke(p0)
    h1 = -fg.quad_log_prob_batched(x1) + ke(p1)
    log_acc = jnp.minimum(0.0, h0 - h1)
    accept = jnp.log(u) < log_acc
    return jnp.where(accept[:, None], x1, xc), log_acc


def test_transition_from_carried_state_matches_reference(grid10):
    """One dense transition from a reference state carried across: the
    same momenta and uniforms give the same accept decisions (where
    log u is not within rounding of log_acc) and the same positions."""
    ref_fg, fg = grid10
    C = 64
    rng = np.random.default_rng(3)
    rs = ref_hmc.init_hmc_state(ref_fg, jax.random.PRNGKey(1),
                                ref_hmc.HMCConfig(init_step_size=0.12), C)
    # start near the posterior so that the energy error, not a downhill
    # roll from the dispersed init, decides acceptance
    J = np.asarray(ref_fg.quad_J, np.float64)
    mode = np.linalg.solve(J, np.asarray(ref_fg.quad_h, np.float64))
    xc0 = mode + rng.normal(size=(C, fg.n_cont)) @ np.linalg.cholesky(
        np.linalg.inv(J)).T
    rs = rs._replace(xc=jnp.asarray(xc0, jnp.float32))
    st = hmc_state_from_numpy(_state_np(rs), "cpu")
    im = rng.uniform(0.5, 1.5, fg.n_cont).astype(np.float32)
    p0 = (rng.normal(size=(C, fg.n_cont)) / np.sqrt(im)).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    eps = 0.5  # large enough that some proposals are rejected
    x_r, lacc_r = _ref_quad_step(ref_fg, rs.xc, jnp.asarray(p0),
                                 jnp.asarray(u), eps, jnp.asarray(im), 8)
    cfg = hmc.HMCConfig(n_leapfrog=8)
    x1, lacc = hmc._quad_proposal(fg, cfg, st.xc, torch.from_numpy(p0),
                                  torch.tensor(eps), torch.from_numpy(im))
    x, prob = hmc._mh_accept(st.xc, x1, lacc, torch.from_numpy(u))
    lacc_r = np.asarray(lacc_r)
    np.testing.assert_allclose(lacc.numpy(), lacc_r, rtol=1e-4, atol=1e-4)
    clear = np.abs(np.log(u) - lacc_r) > 1e-3
    assert clear.sum() > C // 2 and 0 < np.mean(np.log(u) < lacc_r) < 1
    np.testing.assert_allclose(x.numpy()[clear], np.asarray(x_r)[clear],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prob.numpy(), np.exp(lacc_r), rtol=1e-4,
                               atol=1e-4)


def test_dia_transition_matches_reference():
    """The banded proposal with given momenta: the reference's algebra
    (dia.py:516-532) on the same embedded inputs gives the same accept
    decisions and positions as the port's dia_hmc_proposal."""
    g_ref, _ = ref_toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    rfg = ref_compile(g_ref, quad_max_n=64)
    g, _ = toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    fg = lt.compile_graph(g, "cpu", quad_max_n=64)
    C, n = 32, fg.n_cont
    rng = np.random.default_rng(4)
    # near the posterior (dense oracle J of the same graph), so that the
    # energy error decides acceptance
    J = np.asarray(ref_compile(g_ref).quad_J, np.float64)
    mode = np.linalg.solve(J, np.asarray(ref_compile(g_ref).quad_h, np.float64))
    xc = (mode + rng.normal(size=(C, n)) @ np.linalg.cholesky(
        np.linalg.inv(J)).T).astype(np.float32)
    im = rng.uniform(0.5, 1.5, n).astype(np.float32)
    p0 = (rng.normal(size=(C, n)) / np.sqrt(im)).astype(np.float32)
    u = rng.uniform(size=C).astype(np.float32)
    inv = rfg.quad_dia_inv
    emb = lambda a: ref_dia._embed_gather(jnp.asarray(a), inv)  # noqa: E731
    x1e, p1e, lp0, lp1 = ref_dia._jnp_dia_leapfrog(
        emb(xc), emb(p0), emb(rfg.quad_diag), rfg.quad_dia_offsets,
        rfg.quad_dia_w, emb(rfg.quad_h), emb(im), 0.2, 8)
    ime = emb(im)
    ke = lambda p: 0.5 * jnp.sum(ime[None] * p * p, axis=-1)  # noqa: E731
    lacc_r = np.asarray(jnp.minimum(0.0, (lp1 - lp0) + (ke(emb(p0)) - ke(p1e))))
    x_r = np.where((np.log(u) < lacc_r)[:, None],
                   np.asarray(x1e)[:, np.asarray(rfg.quad_dia_pos)], xc)
    x1, lacc = dia_hmc_proposal(
        None, torch.from_numpy(xc), fg.quad_diag, fg.quad_dia_offsets,
        fg.quad_dia_w, fg.quad_h, torch.from_numpy(im), 0.2, 8,
        pos=fg.quad_dia_pos, inv=fg.quad_dia_inv, p0=torch.from_numpy(p0))
    x, _ = hmc._mh_accept(torch.from_numpy(xc), x1, lacc, torch.from_numpy(u))
    clear = np.abs(np.log(u) - lacc_r) > 1e-3
    assert clear.sum() > C // 2 and 0 < np.mean(np.log(u) < lacc_r) < 1
    np.testing.assert_allclose(x.numpy()[clear], x_r[clear], rtol=1e-5,
                               atol=1e-5)


def _moments_vs_oracle(g_ref, g, compile_kw, cfg, n_chains, n_warmup,
                       n_samples):
    oracle, latents = gabp.dense_gaussian_marginals(g_ref)
    fg = lt.compile_graph(g, "cpu", **compile_kw)
    assert fg.cont_pure_quad
    res = hmc.sample(fg, torch.Generator().manual_seed(3), cfg=cfg,
                     n_chains=n_chains, n_warmup=n_warmup,
                     n_samples=n_samples, collect="moments")
    # latents in declaration order in both graphs
    port_latents = [rv for rv in g.rvs if not rv.observed]
    assert [rv.name for rv in port_latents] == [rv.name for rv in latents]
    errs = [abs(res.mean(p) - oracle[id(r)][0])
            for p, r in zip(port_latents, latents)]
    vrel = [abs(res.var(p) - oracle[id(r)][1]) / oracle[id(r)][1]
            for p, r in zip(port_latents, latents)]
    assert res.map(port_latents[0]) == res.mean(port_latents[0])
    assert 0.5 < float(res.diag["accept_rate"]) <= 1.0
    assert np.isfinite(res.diag["rhat"]).all()
    return fg, np.mean(errs), np.mean(vrel)


def test_slice_moments_match_exact_oracle_dense():
    """The slice end to end on the dense path (tests/test_hmc.py:60-79
    thresholds): mean abs error < 0.08, mean relative variance error < 0.2."""
    g_ref, _ = ref_toy.gaussian_grid(5, 5, seed=4, evidence_frac=0.2)
    g, _ = toy.gaussian_grid(5, 5, seed=4, evidence_frac=0.2)
    fg, err, vrel = _moments_vs_oracle(g_ref, g, {}, hmc.HMCConfig(), 64,
                                       400, 800)
    assert not fg.quad_sparse
    assert err < 0.08, err
    assert vrel < 0.2, vrel


def test_slice_moments_match_exact_oracle_dia():
    """The same on the banded path: a 16×16 evidence grid forced past the
    dense cap lands on DIA (K2's plain version on the CPU)."""
    g_ref, _ = ref_toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    g, _ = toy.gaussian_grid(16, 16, seed=0, evidence_frac=0.15)
    fg, err, vrel = _moments_vs_oracle(
        g_ref, g, {"quad_max_n": 64}, hmc.HMCConfig(init_step_size=0.2), 32,
        200, 400)
    assert hmc._use_dia(fg, hmc.HMCConfig())
    assert err < 0.08, err
    assert vrel < 0.2, vrel


def test_samples_mode_and_thin():
    """collect="samples" returns [S, C, n] draws; ``thin`` keeps every
    thin-th state; the ELL path (dia_kernel=False) runs too."""
    g, _ = toy.gaussian_grid(6, 6, seed=2, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu", quad_max_n=8)
    cfg = hmc.HMCConfig(dia_kernel=False, init_step_size=0.2)
    s_xc, s_xd, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(0), cfg,
                                   n_chains=4, n_warmup=20, n_samples=7,
                                   thin=3)
    assert s_xc.shape == (7, 4, fg.n_cont) and s_xd.shape == (7, 4, 0)
    assert torch.isfinite(s_xc).all() and 0 <= float(diag["accept_rate"]) <= 1
    res = hmc.HMCResult(fg, s_xc, s_xd, diag)
    rv = next(rv for rv in g.rvs if not rv.observed)
    assert res.map(rv) == res.mean(rv) and res.var(rv) >= 0


def test_accept_rate_under_thin_keeps_the_last_transition():
    """Under ``thin`` the reference reports each block's LAST transition's
    mean acceptance (its fori_loop carry, lhvi_tpu/engines/hmc.py:900-910).
    Replaying run_hmc's transitions by hand on an identically seeded
    generator gives exactly that mean, which differs from the mean over
    all transitions."""
    g, _ = toy.gaussian_grid(4, 4, seed=1, evidence_frac=0.2)
    fg = lt.compile_graph(g, "cpu")
    cfg = hmc.HMCConfig(n_leapfrog=4, init_step_size=0.4)
    C, W, S, thin = 16, 0, 5, 3
    _, _, diag = hmc.run_hmc(fg, torch.Generator().manual_seed(7), cfg,
                             n_chains=C, n_warmup=W, n_samples=S, thin=thin,
                             collect="moments")
    gen = torch.Generator().manual_seed(7)
    state = hmc.init_hmc_state(fg, gen, cfg, C)
    state = hmc.run_warmup(
        fg, cfg, state, W, lambda s, a: hmc.hmc_transition(fg, cfg, s, gen, a))
    accs = np.zeros((S, thin))
    for t in range(S):
        for i in range(thin):
            state, acc = hmc.hmc_transition(fg, cfg, state, gen, False)
            accs[t, i] = float(torch.mean(acc))
    last = accs[:, -1].mean()
    assert float(diag["accept_rate"]) == pytest.approx(last, rel=1e-6)
    assert abs(accs.mean() - last) > 1e-3


def test_out_of_slice_paths_raise():
    """No HMC option is out of the port any more: ``mode_swap`` runs (on
    these graphs no discrete class qualifies, so it warns and runs plain
    Gibbs, as the reference); hybrid models and ``fused_logpot`` run (the
    flag is ignored on pure-quadratic targets, as in the reference)."""
    gen = torch.Generator().manual_seed(0)
    for g in (toy.hybrid_chain()[0], toy.gaussian_grid(3, 3, seed=0)[0]):
        fg = lt.compile_graph(g, "cpu")
        with pytest.warns(UserWarning, match="no-op"):
            s_xc, _, diag = hmc.run_hmc(fg, gen, hmc.HMCConfig(mode_swap=True),
                                        n_chains=2, n_warmup=2, n_samples=2)
        assert s_xc.shape == (2, 2, fg.n_cont)
        assert "mode_swap_accept" not in diag
        s_xc, s_xd, _ = hmc.run_hmc(fg, gen, hmc.HMCConfig(fused_logpot=True),
                                    n_chains=2, n_warmup=2, n_samples=2)
        assert s_xc.shape == (2, 2, fg.n_cont)
        assert s_xd.shape == (2, 2, fg.n_disc)


def test_port_imports_without_jax():
    """Every module of the port (the runtime's too: config, the
    checkpoints, diagnostics, metrics and NaN checks, resumable sampling,
    the sharding over torch.distributed) and every example script of the
    port (``examples/torch_*.py``, imported as modules with jax and the
    JAX package blocked) imports in a fresh interpreter without pulling in
    jax, flax, orbax or the JAX package: the guard that keeps
    chip_smoke.py runnable where JAX is not installed."""
    code = (
        "import importlib, importlib.abc, pkgutil, sys\n"
        "BLOCK = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'lhvi_tpu')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCK:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "import lhvi_tpu_torch, lhvi_tpu_torch.engines.hmc\n"
        "import lhvi_tpu_torch.config, lhvi_tpu_torch.engines.resumable\n"
        "import lhvi_tpu_torch.parallel.mesh, lhvi_tpu_torch.utils.checkpoint\n"
        "import lhvi_tpu_torch.utils.diagnostics, lhvi_tpu_torch.utils.metrics\n"
        "import lhvi_tpu_torch.utils.debug\n"
        "for m in pkgutil.walk_packages(lhvi_tpu_torch.__path__,"
        " 'lhvi_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in BLOCK)\n"
        "assert not bad, bad\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path.insert(0, 'examples')\n"
        "import pathlib\n"
        "for f in sorted(pathlib.Path('examples').glob('torch_*.py')):\n"
        "    importlib.import_module(f.stem)\n"
        "assert len(list(pathlib.Path('examples').glob('torch_*.py'))) == 10\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py prints no result and exits non-zero where there is no
    CUDA device (it never falls back to the CPU)."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout == ""
