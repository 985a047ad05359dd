"""Plain reference of the grid Gaussian MRF (``configs/gauss_grid128.json``).

NumPy, SciPy and plain PyTorch only: nothing of the program.

The model, over the nodes ``i = r * cols + c`` of a ``rows x cols`` grid:

    log p(x) = sum_i -(x_i - m_i)^2 / (2 unary_var)
             + sum_(a->b) -(x_b - coeff x_a)^2 / (2 sig)   + const

with an edge ``a -> b`` from each node to its right and its lower
neighbour, and the observed nodes clamped to their values. Its
information form is ``J_aa += coeff^2 / sig``, ``J_bb += 1 / sig``,
``J_ab = J_ba = -coeff / sig`` per edge and ``J_ii += 1 / unary_var``,
``h_i = m_i / unary_var``; the latent posterior is
``N(J_LL^-1 (h_L - J_LO x_O), J_LL^-1)``.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

_INPUT_TAG = 0x67726964  # the generator's stream for the inputs


def seed_sequence(seed: int, *tags: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) % 2**64, *tags])


def make_inputs(cfg: dict, seed: int) -> dict:
    """The unary means, the observed set and the observed values, from the
    seed: ``m ~ N(0, unary_mean_sd^2)``, exactly ``n_observed`` nodes,
    ``x_O ~ N(m_O, evidence_sd^2)``."""
    rng = np.random.default_rng(seed_sequence(seed, _INPUT_TAG))
    n = cfg["rows"] * cfg["cols"]
    m = rng.normal(0.0, cfg["unary_mean_sd"], n)
    obs = np.sort(rng.choice(n, cfg["n_observed"], replace=False))
    val = rng.normal(m[obs], cfg["evidence_sd"])
    return dict(unary_mean=m, obs_idx=obs, obs_val=val)


def latent_nodes(cfg: dict, inputs: dict) -> np.ndarray:
    """Grid indices of the latent nodes, ascending (the reference's order)."""
    n = cfg["rows"] * cfg["cols"]
    lat = np.ones(n, bool)
    lat[inputs["obs_idx"]] = False
    return np.flatnonzero(lat)


def edges(cfg: dict):
    """(a, b) node arrays of the right and down edges."""
    R, C = cfg["rows"], cfg["cols"]
    idx = np.arange(R * C).reshape(R, C)
    a = np.concatenate([idx[:, :-1].ravel(), idx[:-1, :].ravel()])
    b = np.concatenate([idx[:, 1:].ravel(), idx[1:, :].ravel()])
    return a, b


def information_form(cfg: dict, inputs: dict):
    """(J_LL as CSC, h_L) in float64, latent nodes in ascending order."""
    n = cfg["rows"] * cfg["cols"]
    c, s, uv = cfg["coeff"], cfg["sig"], cfg["unary_var"]
    a, b = edges(cfg)
    diag = np.full(n, 1.0 / uv)
    np.add.at(diag, a, c * c / s)
    np.add.at(diag, b, 1.0 / s)
    rows = np.concatenate([np.arange(n), a, b])
    cols = np.concatenate([np.arange(n), b, a])
    vals = np.concatenate([diag, np.full(2 * len(a), -c / s)])
    J = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    h = inputs["unary_mean"] / uv
    lat = latent_nodes(cfg, inputs)
    obs, xo = inputs["obs_idx"], inputs["obs_val"]
    h_l = h[lat] - J[lat][:, obs] @ xo
    return J[lat][:, lat].tocsc(), h_l


def posterior(cfg: dict, inputs: dict, spots: np.ndarray):
    """Exact posterior means of every latent and variances of the latents
    ``spots`` (positions in the latent order), by one sparse LU."""
    J, h = information_form(cfg, inputs)
    lu = spla.splu(J)
    mean = lu.solve(h)
    E = np.zeros((J.shape[0], len(spots)))
    E[spots, np.arange(len(spots))] = 1.0
    var = lu.solve(E)[spots, np.arange(len(spots))]
    return mean, var


class StreamedDiagnostics:
    """Convergence diagnostics of ``n_samples`` draws of every chain,
    streamed one draw at a time, every accumulator ``[chains, ...]`` in the
    draws' dtype (Gelman et al., Bayesian Data Analysis, 3rd ed., 11.4-5):

    - ``rhat``: split-R-hat over the two halves of ``h = S // 2`` draws of
      every chain, ``sqrt(((h - 1) / h W + B / h) / W)`` with ``W`` the mean
      of the ``2 C`` halves' variances and ``B = h var(halves' means)``;
    - ``ess_proxy``: ``S C (1 - rho) / (1 + rho)``, ``rho`` the chains' mean
      lag-1 autocorrelation, clamped to ``[0, 0.999]``;
    - ``ess_bm``: batch means: batches of ``b = floor(sqrt(S))`` draws,
      ``tau = b var(batch means) / var(draws)`` per chain, ``ESS`` the sum
      over the chains of ``min(S / tau, S)`` (``S`` for a chain that never
      moved).
    """

    def __init__(self, n_samples: int, like: torch.Tensor):
        self.S, self.h = n_samples, n_samples // 2
        self.b = max(1, int(math.isqrt(n_samples)))
        self.nb = n_samples // self.b
        z = lambda: torch.zeros_like(like)  # noqa: E731
        self.mean = [z(), z()]  # Welford pair of each half
        self.m2 = [z(), z()]
        self.cross, self.prev = z(), z()
        self.batch_sum, self.bm_mean, self.bm_m2 = z(), z(), z()

    def add(self, t: int, x: torch.Tensor) -> None:
        """Fold in draw ``t`` (0-based) of every chain."""
        half, k = divmod(t, self.h)
        if half < 2:
            d = x - self.mean[half]
            self.mean[half] = self.mean[half] + d / (k + 1)
            self.m2[half] = self.m2[half] + d * (x - self.mean[half])
        if t > 0:
            self.cross = self.cross + x * self.prev
        self.prev = x
        batch, pos = divmod(t, self.b)
        if batch < self.nb:
            self.batch_sum = self.batch_sum + x
            if pos == self.b - 1:
                bmean = self.batch_sum / self.b
                d = bmean - self.bm_mean
                self.bm_mean = self.bm_mean + d / (batch + 1)
                self.bm_m2 = self.bm_m2 + d * (bmean - self.bm_mean)
                self.batch_sum = torch.zeros_like(x)

    def result(self) -> dict:
        """``rhat``, ``ess_proxy``, ``ess_bm`` over the trailing shape."""
        h, S = self.h, self.S
        C = self.prev.shape[0]
        means = torch.cat(self.mean)
        W = torch.mean(torch.cat(self.m2) / (h - 1), dim=0)
        B = h * torch.var(means, dim=0)
        rhat = torch.sqrt(((h - 1) / h * W + B / h) / W)
        d = self.mean[0] - self.mean[1]
        full_mean = (self.mean[0] + self.mean[1]) / 2
        full_var = (self.m2[0] + self.m2[1] + h / 2 * d * d) / (2 * h - 1)
        rho = torch.mean((self.cross / (S - 1) - full_mean * full_mean)
                         / full_var, dim=0).clamp(0.0, 0.999)
        ess_proxy = S * C * (1 - rho) / (1 + rho)
        tau = self.b * self.bm_m2 / (self.nb - 1) / full_var
        ess_c = torch.where(full_var > 0, torch.clamp(S / tau, max=S),
                            torch.full_like(tau, S))
        return dict(rhat=rhat, ess_proxy=ess_proxy,
                    ess_bm=torch.sum(ess_c, dim=0))


def gibbs_moments(cfg: dict, inputs: dict, n_chains: int, n_warmup: int,
                  n_samples: int, seed: int, dtype=torch.float32,
                  device="cpu"):
    """Posterior means, variances and diagnostics (``StreamedDiagnostics``)
    of the latents by a plain exact sampler in ``dtype``: chromatic
    (checkerboard) Gibbs over the whole grid, observed nodes clamped,
    chains from 0, moments streamed as sums over the chains of each sweep
    as a sampler of the program would. Every tensor is in ``dtype``; it
    stands in for the program in the control."""
    R, Cc = cfg["rows"], cfg["cols"]
    c, s, uv = cfg["coeff"], cfg["sig"], cfg["unary_var"]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,  # noqa: E731
                                  device=device)
    gen = torch.Generator(device).manual_seed(
        int(seed_sequence(seed, 1).generate_state(1)[0]))
    n = R * Cc
    a, b = edges(cfg)
    prec = np.full(n, 1.0 / uv)
    np.add.at(prec, a, c * c / s)
    np.add.at(prec, b, 1.0 / s)
    prec = t(prec.reshape(R, Cc))
    lin = t((inputs["unary_mean"] / uv).reshape(R, Cc))
    sd = torch.rsqrt(prec)
    clamp = np.zeros(n, bool)
    clamp[inputs["obs_idx"]] = True
    clamp = torch.as_tensor(clamp.reshape(R, Cc), device=device)
    xo = np.zeros(n)
    xo[inputs["obs_idx"]] = inputs["obs_val"]
    xo = t(xo.reshape(R, Cc))
    parity = torch.as_tensor(
        (np.add.outer(np.arange(R), np.arange(Cc)) % 2).astype(bool),
        device=device)
    k = c / s

    def nbr_sum(x):
        out = torch.zeros_like(x)
        out[:, :, 1:] += x[:, :, :-1]
        out[:, :, :-1] += x[:, :, 1:]
        out[:, 1:, :] += x[:, :-1, :]
        out[:, :-1, :] += x[:, 1:, :]
        return out

    x = torch.where(clamp, xo, torch.zeros((), dtype=dtype, device=device))
    x = x.expand(n_chains, R, Cc).clone()
    s1 = torch.zeros((R, Cc), dtype=dtype, device=device)
    s2 = torch.zeros((R, Cc), dtype=dtype, device=device)
    diag = StreamedDiagnostics(n_samples, x)
    for sweep in range(n_warmup + n_samples):
        for colour in (False, True):
            mean = (lin + k * nbr_sum(x)) / prec
            z = torch.randn(x.shape, generator=gen, dtype=dtype,
                            device=device)
            upd = (parity == colour) & ~clamp
            x = torch.where(upd, mean + sd * z, x)
        if sweep >= n_warmup:
            s1 = s1 + torch.sum(x, dim=0)
            s2 = s2 + torch.sum(x * x, dim=0)
            diag.add(sweep - n_warmup, x)
    n_obs = n_chains * n_samples
    m = s1 / n_obs
    v = s2 / n_obs - m * m
    lat = latent_nodes(cfg, inputs)

    def host(a):
        return a.reshape(-1)[lat].double().cpu().numpy()

    return host(m), host(v), {k: host(a) for k, a in diag.result().items()}
