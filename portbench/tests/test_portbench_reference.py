"""The plain references meet their closed forms at tiny sizes, and the
import guard holds."""

from __future__ import annotations

import itertools
import math
import types

import numpy as np
import pytest
import torch

from portbench import guard
from portbench.registry import PKG, Registry


def grid_cfg(rows=5, cols=4, n_observed=3):
    cfg = Registry().json("configs", "gauss_grid128")
    return dict(cfg, rows=rows, cols=cols, n_observed=n_observed,
                n_latent=rows * cols - n_observed)


def test_grid_posterior_is_the_dense_solve():
    ref = Registry().module("reference", "gauss_grid128")
    cfg = grid_cfg()
    inputs = ref.make_inputs(cfg, 7)
    n = cfg["rows"] * cfg["cols"]
    # the log-density written out term by term, its Hessian by hand
    J = np.zeros((n, n))
    J[np.arange(n), np.arange(n)] = 1.0 / cfg["unary_var"]
    c, s = cfg["coeff"], cfg["sig"]
    for r in range(cfg["rows"]):
        for q in range(cfg["cols"]):
            i = r * cfg["cols"] + q
            for j in ([i + 1] if q + 1 < cfg["cols"] else []) + (
                    [i + cfg["cols"]] if r + 1 < cfg["rows"] else []):
                J[i, i] += c * c / s
                J[j, j] += 1.0 / s
                J[i, j] -= c / s
                J[j, i] -= c / s
    h = inputs["unary_mean"] / cfg["unary_var"]
    lat = ref.latent_nodes(cfg, inputs)
    obs = inputs["obs_idx"]
    Jll = J[np.ix_(lat, lat)]
    mean = np.linalg.solve(Jll, h[lat] - J[np.ix_(lat, obs)]
                           @ inputs["obs_val"])
    cov = np.linalg.inv(Jll)
    spots = np.array([0, 3, len(lat) - 1])
    m, v = ref.posterior(cfg, inputs, spots)
    np.testing.assert_allclose(m, mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v, np.diag(cov)[spots], rtol=1e-10)
    assert len(lat) == cfg["n_latent"]


def test_grid_inputs_follow_the_seed():
    ref = Registry().module("reference", "gauss_grid128")
    cfg = Registry().json("configs", "gauss_grid128")
    a, b = ref.make_inputs(cfg, 2**31 + 5), ref.make_inputs(cfg, 2**31 + 5)
    c = ref.make_inputs(cfg, 2**31 + 6)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["obs_idx"], c["obs_idx"])
    assert len(ref.latent_nodes(cfg, c)) == cfg["n_latent"] == 15600


def test_grid_sampler_is_exact_in_float32_and_not_in_bfloat16():
    """The control's sampler: sound in float32, off in bfloat16."""
    ref = Registry().module("reference", "gauss_grid128")
    cfg = grid_cfg(8, 8, 4)
    inputs = ref.make_inputs(cfg, 3)
    mean, var = ref.posterior(cfg, inputs, np.arange(cfg["n_latent"]))
    m32, v32, _ = ref.gibbs_moments(cfg, inputs, 256, 50, 200, seed=1)
    m16, v16, _ = ref.gibbs_moments(cfg, inputs, 256, 50, 200, seed=1,
                                    dtype=torch.bfloat16)
    e32 = np.abs(m32 - mean).max(), (np.abs(v32 - var) / var).max()
    e16 = np.abs(m16 - mean).max(), (np.abs(v16 - var) / var).max()
    assert e32[0] < 0.05 and e32[1] < 0.1
    assert e16[0] > 3 * e32[0] or e16[1] > 3 * e32[1]


@pytest.mark.parametrize("n_samples", [40, 41])
def test_streamed_diagnostics_are_the_stored_draws(n_samples):
    """The reference's streamed split-R-hat and ESS equal the textbook
    formulas over the stored draws (an AR(1) chain, one frozen column)."""
    ref = Registry().module("reference", "gauss_grid128")
    rng = np.random.default_rng(0)
    C, n, S = 6, 3, n_samples
    x = np.zeros((S, C, n))
    for t in range(1, S):
        x[t] = 0.6 * x[t - 1] + rng.normal(size=(C, n))
    x[:, :, 2] = 1.5
    sd = ref.StreamedDiagnostics(S, torch.zeros(C, n, dtype=torch.float64))
    for t in range(S):
        sd.add(t, torch.as_tensor(x[t]))
    got = {k: v.numpy() for k, v in sd.result().items()}
    h = S // 2
    halves = np.concatenate([x[:h], x[h:2 * h]], axis=1)
    W = halves.var(0, ddof=1).mean(0)[:2]
    B = h * halves.mean(0).var(0, ddof=1)[:2]
    np.testing.assert_allclose(got["rhat"][:2],
                               np.sqrt(((h - 1) / h * W + B / h) / W),
                               rtol=1e-10)
    full = x[:2 * h]
    m, v = full.mean(0), full.var(0, ddof=1)
    rho = ((x[1:] * x[:-1]).sum(0)[:, :2] / (S - 1) - m[:, :2] ** 2) \
        / v[:, :2]
    rho = np.clip(rho.mean(0), 0.0, 0.999)
    np.testing.assert_allclose(got["ess_proxy"][:2],
                               S * C * (1 - rho) / (1 + rho), rtol=1e-10)
    b = int(math.isqrt(S))
    nb = S // b
    bm = x[:nb * b].reshape(nb, b, C, n).mean(1)
    tau = b * bm.var(0, ddof=1)[:, :2] / v[:, :2]
    ess = np.minimum(S / tau, S).sum(0)
    np.testing.assert_allclose(got["ess_bm"][:2], ess, rtol=1e-10)
    assert got["ess_bm"][2] == S * C


def fs_cfg(n=3, k=1):
    cfg = Registry().json("configs", "friends_smokers320")
    return dict(cfg, n_people=n, n_observed=k)


def enumerate_expectation(cfg, inputs, q, n_quad):
    """E_q[log p] of one mixture component (K = 1) by enumerating every
    binary state, stress by quadrature: the brute force of the reference's
    vectorized sums."""
    N = cfg["n_people"]
    w_sc, w_fr, w_st = (cfg["w_smokes_cancer"], cfg["w_friends"],
                        cfg["w_stress"])
    p1 = lambda lg: np.exp(lg[..., 1]) / np.exp(lg).sum(-1)  # noqa: E731
    ps = p1(q["smokes_logits"][0])
    ps[inputs["obs_idx"]] = inputs["obs_smokes"]
    pc, pf = p1(q["cancer_logits"][0]), p1(q["friends_logits"][0])
    pairs = [(i, j) for i in range(N) for j in range(N) if i != j]
    x, wq = np.polynomial.hermite.hermgauss(n_quad)
    wq = wq / math.sqrt(math.pi)
    mu, sg = q["mu"][0], np.exp(q["log_sigma"][0])
    total = 0.0
    for s in itertools.product([0, 1], repeat=N):
        ws = np.prod([ps[i] if s[i] else 1 - ps[i] for i in range(N)])
        for c in itertools.product([0, 1], repeat=N):
            wc = np.prod([pc[i] if c[i] else 1 - pc[i] for i in range(N)])
            lp = sum(w_sc * (1 - s[i] + s[i] * c[i]) for i in range(N))
            for (i, j) in pairs:   # friends enter linearly: E over f
                eq = s[i] * s[j] + (1 - s[i]) * (1 - s[j])
                lp += w_fr * (1 - pf[i, j] + pf[i, j] * eq)
            for i in range(N):
                t = mu[i] + math.sqrt(2) * sg[i] * x
                lp += np.sum(wq * (-0.5 * math.log(2 * math.pi) - 0.5 * t * t))
                lp += w_st * s[i] * np.sum(wq / (1 + np.exp(-2 * t)))
            total += ws * wc * lp
    return total


def test_fs_elbo_matches_enumeration_at_one_component():
    ref = Registry().module("reference", "friends_smokers320")
    cfg = fs_cfg()
    inputs = ref.make_inputs(cfg, 11)
    N, rng = cfg["n_people"], np.random.default_rng(0)
    q = dict(log_w=np.zeros(1), mu=rng.normal(size=(1, N)),
             log_sigma=rng.normal(scale=0.3, size=(1, N)),
             smokes_logits=rng.normal(size=(1, N, 2)),
             cancer_logits=rng.normal(size=(1, N, 2)),
             friends_logits=rng.normal(size=(1, N, N, 2)))
    expected = enumerate_expectation(cfg, inputs, q, 7)
    lat = np.ones(N, bool)
    lat[inputs["obs_idx"]] = False
    p1 = lambda lg: np.exp(lg[..., 1]) / np.exp(lg).sum(-1)  # noqa: E731
    probs = np.concatenate([p1(q["smokes_logits"][0])[lat],
                            p1(q["cancer_logits"][0]),
                            p1(q["friends_logits"][0])[~np.eye(N, dtype=bool)]])
    h = -np.sum(probs * np.log(probs) + (1 - probs) * np.log(1 - probs))
    h += np.sum(q["log_sigma"][0] + 0.5 * math.log(2 * math.pi * math.e))
    assert ref.elbo(cfg, inputs, q, 7) == pytest.approx(expected + h,
                                                        rel=1e-12)


def test_fs_cancer_closed_form_by_enumeration():
    """P(cancer = 1 | smokes observed) of the whole tiny model, summed
    over every other variable (stress on a fine grid), against sigma(w) and
    1/2."""
    ref = Registry().module("reference", "friends_smokers320")
    cfg = fs_cfg(3, 2)
    inputs = dict(obs_idx=np.array([0, 1]), obs_smokes=np.array([1, 0]))
    N = cfg["n_people"]
    t = np.linspace(-5, 5, 401)
    prior = np.exp(-0.5 * t * t)
    pairs = [(i, j) for i in range(N) for j in range(N) if i != j]
    num = np.zeros(N)
    den = 0.0
    for s2 in (0, 1):
        s = [1, 0, s2]
        for c in itertools.product([0, 1], repeat=N):
            lp = sum(cfg["w_smokes_cancer"] * (1 - s[i] + s[i] * c[i])
                     for i in range(N))
            for (i, j) in pairs:
                eq = s[i] * s[j] + (1 - s[i]) * (1 - s[j])
                lp += np.log(np.exp(cfg["w_friends"])
                             + np.exp(cfg["w_friends"] * eq))
            w = np.exp(lp) * np.prod([np.sum(prior * np.exp(
                cfg["w_stress"] * s[i] / (1 + np.exp(-2 * t))))
                for i in range(N)])
            den += w
            num += w * np.array(c)
    np.testing.assert_allclose(num[:2] / den,
                               ref.cancer_closed_form(cfg, inputs),
                               rtol=1e-12)


def test_import_guard():
    assert guard.forbidden_loaded(["jax.numpy", "lhvi_tpu_torch.engines",
                                   "lhvi_tpu.ops", "jaxlib", "jaxtyping",
                                   "flax.linen"]) == ["flax.linen",
                                                      "jax.numpy", "jaxlib",
                                                      "lhvi_tpu.ops"]
    assert guard.source_offences(PKG) == []


def test_import_guard_sees_the_program(tmp_path):
    ref = tmp_path / "reference"
    ref.mkdir()
    (ref / "a.py").write_text("import numpy\nfrom lhvi_tpu_torch import x\n")
    (ref / "b.py").write_text("import jax.numpy as jnp\n")
    (ref / "c.py").write_text("from . import lhvi_tpu\nimport lhvi_tpu_torchx\n")
    (tmp_path / "d.py").write_text("from lhvi_tpu_torch import x\n")
    (tmp_path / "e.py").write_text("import lhvi_tpu.ops\nimport flax\n")
    assert guard.source_offences(tmp_path) == [
        "e.py: flax", "e.py: lhvi_tpu", "reference/a.py: lhvi_tpu_torch",
        "reference/b.py: jax"]


def test_grid_judge_reads_the_diagnostics():
    """R-hat's gap and the ESS gaps on synthetic answers: an ESS twice the
    one the mean's error shows reads log 2; a missing stream reads inf."""
    judge = Registry().module("judges", "gauss_grid128.hmc_moments")
    n = 100
    exact_mean, exact_var = np.linspace(-1, 1, n), np.full(n, 2.0)
    ref = types.SimpleNamespace(posterior=lambda cfg, inputs, spots: (
        exact_mean, exact_var[spots]))
    err = np.where(np.arange(n) % 2, 0.01, -0.01)
    ess = np.full(n, 2.0 * 2.0 / 0.01 ** 2)  # var / err^2 = 2e4, doubled
    answer = dict(mean=exact_mean + err, var=exact_var,
                  diag=dict(rhat=np.full(n, 1.02), ess_bm=ess,
                            ess_proxy=ess / 2, accept_rate=0.8))
    limits = dict(mean_err_max=1, var_err_max=1, rhat_gap=1, ess_bm_gap=1,
                  ess_proxy_gap=1)
    rng = np.random.default_rng(0)
    got = {k: v for k, v, _ in judge.judge(
        ref, dict(n_latent=n), {}, np.arange(n), [answer], limits, rng, {})}
    assert got["mean_err_max"] == pytest.approx(0.01)
    assert got["rhat_gap"] == pytest.approx(0.02)
    assert got["ess_bm_gap"] == pytest.approx(math.log(2))
    assert got["ess_proxy_gap"] == pytest.approx(0.0, abs=1e-12)
    del answer["diag"]
    got = {k: v for k, v, _ in judge.judge(
        ref, dict(n_latent=n), {}, np.arange(n), [answer], limits, rng, {})}
    assert got["rhat_gap"] == got["ess_bm_gap"] == float("inf")
