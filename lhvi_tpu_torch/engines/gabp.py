"""Gaussian belief propagation (PyTorch port of ``lhvi_tpu/engines/gabp.py``).

The host side extracts the information form (J, h) of any Gaussian-quadratic
model — ``log p = −½ xᵀJx + hᵀx + const`` — from the factor graph
(GaussianPotential / LinearGaussianPotential / QuadraticPotential /
XYPotential terms; evidence is conditioned out), then runs the classic
Weiss–Freeman directed-edge message recursion

    α_{i→j} = −J_ij² / (J_ii + Σ_{k∈N(i)∖j} α_{k→i})
    β_{i→j} = −J_ij · (h_i + Σ_{k∈N(i)∖j} β_{k→i}) / (J_ii + Σ α)

Messages live in flat directed-edge tensors on the device; each sweep is
two ``index_add_`` segment sums over the edges and a gather (the
reference's ``.at[].add``; on CUDA the atomic sums add in another order, so
the card's results equal the CPU's within f32 rounding, not bitwise).
Exact means on walk-summable models; exact variances on trees.

``dense_gaussian_marginals`` solves (J, h) directly and is the exact
oracle on small and medium Gaussian graphs.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from lhvi_tpu_torch.fg.graph import Graph, RV


def information_form(g: Graph) -> Tuple[np.ndarray, np.ndarray, list]:
    """Extract (J, h, latent_rvs) with evidence conditioned out.

    Raises TypeError on non-Gaussian-quadratic potentials.
    """
    from lhvi_tpu_torch.fg.quad import accumulate_information_form

    g.init_nb()
    latents = [rv for rv in g.rvs if not rv.observed]
    if any(not rv.domain.continuous for rv in latents):
        raise TypeError("GaBP requires all latent variables continuous")
    loc = {id(rv): i for i, rv in enumerate(latents)}

    class _Shim:
        def loc(self, rv):
            return ("c", loc[id(rv)]) if id(rv) in loc else ("obs", -1)

    try:
        J, h, _ = accumulate_information_form(g.factors, _Shim(), len(latents))
    except TypeError as e:
        raise TypeError(f"GaBP cannot handle this model: {e}") from e
    return J, h, latents


def sparse_information_form(g: Graph):
    """Extract (J_diag [n], h [n], off-diagonal dict {(i,j): J_ij},
    latent_rvs) directly from factor adjacency — O(Σ arity²) host work and
    O(E) memory, never materializing the dense J.
    """
    from lhvi_tpu_torch.fg.quad import local_quadratic

    g.init_nb()
    latents = [rv for rv in g.rvs if not rv.observed]
    if any(not rv.domain.continuous for rv in latents):
        raise TypeError("GaBP requires all latent variables continuous")
    loc = {id(rv): i for i, rv in enumerate(latents)}
    n = len(latents)
    J_diag = np.zeros(n)
    h = np.zeros(n)
    off: dict = {}
    for f in g.factors:
        try:
            Jp, hp, _ = local_quadratic(f.potential, len(f.nb))
        except TypeError as e:
            raise TypeError(f"GaBP cannot handle this model: {e}") from e
        idx, vals = [], []
        for rv in f.nb:
            if id(rv) in loc:
                idx.append(loc[id(rv)])
                vals.append(0.0)
            else:
                idx.append(-1)
                vals.append(float(rv.value))
        for a, ia in enumerate(idx):
            if ia < 0:
                continue
            h[ia] += hp[a]
            for b, ib in enumerate(idx):
                if ib < 0:
                    h[ia] -= Jp[a, b] * vals[b]
                elif ib == ia:
                    J_diag[ia] += Jp[a, b]
                else:
                    key = (ia, ib)
                    off[key] = off.get(key, 0.0) + Jp[a, b]
    return J_diag, h, off, latents


def dense_gaussian_marginals(g: Graph):
    """Exact Gaussian marginals by dense solve (test oracle)."""
    J, h, latents = information_form(g)
    cov = np.linalg.inv(J)
    mean = cov @ h
    return {id(rv): (mean[i], cov[i, i]) for i, rv in enumerate(latents)}, latents


def _gabp_sweeps(J_diag, h, e_src, e_dst, e_J, e_rev, iters: int):
    """Directed-edge GaBP as segment-sum sweeps →
    ``(mean [n], var [n], last message delta)`` (0-d tensors stay on the
    device).

    e_src/e_dst: i64 [E] endpoints; e_J: f32 [E] coupling J_{src,dst};
    e_rev: i64 [E] index of the reverse edge.
    """
    n, E = J_diag.shape[0], e_src.shape[0]
    dev = J_diag.device
    alpha = torch.zeros(E, device=dev)
    beta = torch.zeros(E, device=dev)

    def seg(v):  # Σ over the edges into each node
        return torch.zeros(n, device=dev).index_add_(0, e_dst, v)

    delta = torch.zeros((), device=dev)
    for _ in range(iters):
        in_a, in_b = seg(alpha), seg(beta)
        # cavity sums at the source node, excluding the reverse edge
        cav_a = in_a[e_src] - alpha[e_rev]
        cav_b = in_b[e_src] - beta[e_rev]
        prec = J_diag[e_src] + cav_a
        alpha_new = -(e_J * e_J) / prec
        beta_new = -e_J * (h[e_src] + cav_b) / prec
        delta = (torch.max(torch.abs(alpha_new - alpha)) if E
                 else torch.zeros((), device=dev))
        alpha, beta = alpha_new, beta_new
    prec = J_diag + seg(alpha)
    mean = (h + seg(beta)) / prec
    return mean, 1.0 / prec, delta


class GaBP:
    """Engine facade: ``GaBP(g).run(iters)`` then ``mean/var/map`` queries.
    The sweeps run on ``device``, the card unless the caller names
    another."""

    def __init__(self, g: Graph, device="cuda"):
        J_diag, h, off, latents = sparse_information_form(g)
        self.latents = latents
        self.loc = {id(rv): i for i, rv in enumerate(latents)}
        n = len(latents)
        items = sorted((k, v) for k, v in off.items() if v != 0.0)
        src = np.array([k[0] for k, _ in items], np.int64)
        dst = np.array([k[1] for k, _ in items], np.int64)
        cpl = np.array([v for _, v in items], np.float32)
        E = len(items)
        rev_map = {(int(s), int(d)): k for k, (s, d) in
                   enumerate(zip(src, dst))}
        rev = np.array(
            [rev_map[(int(d), int(s))] for s, d in zip(src, dst)], np.int64
        ) if E else np.zeros(0, np.int64)

        # a sufficient walk-summability check: diagonal dominance. GaBP
        # means are exact at convergence on walk-summable models;
        # variances only on trees; outside that regime it can diverge.
        row_abs = np.zeros(n)
        np.add.at(row_abs, src, np.abs(cpl))
        if E and (row_abs >= J_diag).any():
            warnings.warn(
                "GaBP: information matrix is not diagonally dominant; the "
                "model may not be walk-summable and GaBP may diverge "
                "(means exact only at convergence; variances only on trees)",
                RuntimeWarning,
            )
        device = torch.device(device)
        self.device = device
        self.n_edges = E
        self._args = (
            torch.tensor(J_diag, dtype=torch.float32, device=device),
            torch.tensor(h, dtype=torch.float32, device=device),
            torch.tensor(src, device=device),
            torch.tensor(dst, device=device),
            torch.tensor(cpl, device=device),
            torch.tensor(rev, device=device),
        )
        self.mean_ = None
        self.var_ = None
        self.last_delta_ = None

    def run(self, iters: int = 50, warn_tol: float = 1e-5):
        mean, var, delta = _gabp_sweeps(*self._args, iters=iters)
        self.mean_ = mean.cpu().numpy()
        self.var_ = var.cpu().numpy()
        self.last_delta_ = float(delta)
        if not np.isfinite(self.mean_).all() or self.last_delta_ > warn_tol:
            warnings.warn(
                f"GaBP did not converge in {iters} sweeps (last message "
                f"delta {self.last_delta_:.2e}); results are unreliable",
                RuntimeWarning,
            )
        return self

    def _i(self, rv: RV) -> int:
        if id(rv) not in self.loc:
            raise ValueError(f"{rv} is observed or unknown")
        return self.loc[id(rv)]

    def mean(self, rv: RV) -> float:
        return float(self.mean_[self._i(rv)])

    def var(self, rv: RV) -> float:
        return float(self.var_[self._i(rv)])

    def map(self, rv: RV) -> float:
        return self.mean(rv)
