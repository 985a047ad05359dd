"""Quadratic-form extraction (host numpy), for the PyTorch port.

A copy of ``lhvi_tpu/fg/quad.py`` bound to the port's potential classes.
Any factor whose log-potential is quadratic in its continuous arguments
(Gaussian, linear-Gaussian, quadratic, XY) and touches no discrete latents
can be folded into a single information form

    Σ_f scale_f · log φ_f(x) = −½ xᵀ J x + hᵀ x + c

over the continuous latent vector. ``log p`` and ``∇ log p`` then evaluate
as one matmul each instead of gather/scatter chains, which is the
dominant cost of HMC/NUTS/SMC on Gaussian-heavy models. Evidence is
conditioned into (h, c); lifted orbit counts scale each factor's
contribution.

Used by ``fg.compile`` (fusion pass).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from lhvi_tpu_torch.potentials.library import (
    GaussianPotential,
    LinearGaussianPotential,
    QuadraticPotential,
    XYPotential,
)

QUADRATIC_TYPES = (
    GaussianPotential,
    LinearGaussianPotential,
    QuadraticPotential,
    XYPotential,
)


def local_quadratic(p, arity: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """Per-factor (Jp, hp, cp): log φ = −½ xᵀ Jp x + hpᵀ x + cp."""
    if isinstance(p, GaussianPotential):
        prec = np.asarray(p.prec, np.float64)
        mu = np.asarray(p.mu, np.float64)
        h = prec @ mu
        c = float(p.log_coef) - 0.5 * float(mu @ prec @ mu)
        return prec, h, c
    if isinstance(p, LinearGaussianPotential):
        a, v = float(p.coeff), float(p.sig)
        J = np.array([[a * a / v, -a / v], [-a / v, 1.0 / v]])
        return J, np.zeros(2), 0.0
    if isinstance(p, QuadraticPotential):
        A = np.asarray(p.A, np.float64)
        return -(A + A.T), np.asarray(p.b, np.float64), float(p.c)
    if isinstance(p, XYPotential):
        cc = float(p.coeff) / float(p.sig)
        return np.array([[0.0, -cc], [-cc, 0.0]]), np.zeros(2), 0.0
    raise TypeError(f"{type(p).__name__} is not quadratic")


def is_quadratic_factor(f, meta) -> bool:
    """Fusible: quadratic potential, every arg continuous, no discrete."""
    if not isinstance(f.potential, QUADRATIC_TYPES):
        return False
    return all(rv.domain.continuous for rv in f.nb)


def accumulate_information_ell(
    factors, meta, n_cont: int, scales=None, max_deg: int = 128
):
    """Sparse information form for ``n_cont`` past the dense cap.

    Same semantics as :func:`accumulate_information_form`, but J is
    returned in ELL (padded-neighbor) layout — the TPU-friendly sparse
    format: ``J @ x`` is one ``[n, D]`` gather·multiply·sum, no scatters,
    static shapes. Grid/chain Gaussian MRFs
    have D ≤ ~4, so storage is O(n·D) vs the dense O(n²) that hits 1 GB
    at a 128×128 grid.

    Returns ``(diag [n], col [n, D] i32, w [n, D] f32, h [n], c)`` with
    padded slots pointing at row 0 with weight 0, or ``None`` when the
    max off-diagonal row degree exceeds ``max_deg`` (densely coupled
    models — fall back to the unfused bucket path rather than build an
    O(n·n) ELL table).
    """
    diag = np.zeros(n_cont)
    h = np.zeros(n_cont)
    c = 0.0
    rows: list = []
    cols: list = []
    vals: list = []
    for f in factors:
        s = 1.0 if scales is None else scales.get(id(f), 1.0)
        Jp, hp, cp = local_quadratic(f.potential, len(f.nb))
        Jp, hp, cp = s * Jp, s * hp, s * cp
        idx = []
        v0 = []
        for rv in f.nb:
            kind, i = meta.loc(rv)
            if kind == "obs":
                idx.append(-1)
                v0.append(float(rv.value))
            else:
                idx.append(i)
                v0.append(0.0)
        c += cp
        for a, ia in enumerate(idx):
            if ia < 0:
                c += hp[a] * v0[a]
                for b, ib in enumerate(idx):
                    if ib < 0:
                        c += -0.5 * Jp[a, b] * v0[a] * v0[b]
                continue
            h[ia] += hp[a]
            for b, ib in enumerate(idx):
                if ib < 0:
                    h[ia] -= Jp[a, b] * v0[b]
                elif ib == ia:
                    diag[ia] += Jp[a, b]
                else:
                    rows.append(ia)
                    cols.append(ib)
                    vals.append(Jp[a, b])
    if rows:
        r = np.asarray(rows, np.int64)
        cidx = np.asarray(cols, np.int64)
        v = np.asarray(vals, np.float64)
        # coalesce duplicate (row, col) entries
        key = r * n_cont + cidx
        uniq, inv = np.unique(key, return_inverse=True)
        vsum = np.zeros(len(uniq))
        np.add.at(vsum, inv, v)
        r, cidx = uniq // n_cont, uniq % n_cont
        deg = np.bincount(r, minlength=n_cont)
        D = int(deg.max()) if len(deg) else 0
        if D > max_deg:
            return None
        D = max(D, 1)
        col = np.zeros((n_cont, D), np.int32)
        w = np.zeros((n_cont, D), np.float32)
        order = np.argsort(r, kind="stable")
        starts = np.concatenate([[0], np.cumsum(np.bincount(
            r, minlength=n_cont))])
        slot = np.arange(len(r)) - starts[r[order]]
        col[r[order], slot] = cidx[order].astype(np.int32)
        w[r[order], slot] = vsum[order].astype(np.float32)
    else:
        col = np.zeros((n_cont, 1), np.int32)
        w = np.zeros((n_cont, 1), np.float32)
    return (
        diag.astype(np.float32), col, w, h.astype(np.float32), float(c)
    )


def accumulate_information_form(
    factors, meta, n_cont: int, scales=None
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fold a factor list into (J [n,n], h [n], c) with evidence
    conditioned out. ``meta.loc(rv)`` → ('c'|'obs', idx)."""
    J = np.zeros((n_cont, n_cont))
    h = np.zeros(n_cont)
    c = 0.0
    for f in factors:
        s = 1.0 if scales is None else scales.get(id(f), 1.0)
        Jp, hp, cp = local_quadratic(f.potential, len(f.nb))
        Jp, hp, cp = s * Jp, s * hp, s * cp
        idx = []
        vals = []
        for rv in f.nb:
            kind, i = meta.loc(rv)
            if kind == "obs":
                idx.append(-1)
                vals.append(float(rv.value))
            else:
                idx.append(i)
                vals.append(0.0)
        c += cp
        for a, ia in enumerate(idx):
            if ia < 0:
                # const × const terms fold into c
                c += hp[a] * vals[a]
                for b, ib in enumerate(idx):
                    if ib < 0:
                        c += -0.5 * Jp[a, b] * vals[a] * vals[b]
                continue
            h[ia] += hp[a]
            for b, ib in enumerate(idx):
                if ib >= 0:
                    J[ia, ib] += Jp[a, b]
                else:
                    h[ia] -= Jp[a, b] * vals[b]
    return J, h, c
