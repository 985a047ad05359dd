"""Linear-dynamical (Kalman-like) hybrid model (BASELINE config 4).

The same code as ``lhvi_tpu/models/lds.py`` on the port's DSL, with the same
numpy RNG, so the same seed gives the same graph in both packages. The
pure-linear version is a Gaussian MRF whose exact smoothed marginals and
log Z follow from its information form: the SMC oracle model.
"""

from __future__ import annotations

import numpy as np

from lhvi_tpu_torch.fg.graph import Domain, F, Graph, RV
from lhvi_tpu_torch.potentials import (
    GaussianPotential,
    LinearGaussianPotential,
    MLNPotential,
    TablePotential,
)


def kalman_lds(T: int = 20, a: float = 0.9, q: float = 0.5, c: float = 1.0,
               r: float = 0.8, seed: int = 0):
    """x_t = a·x_{t−1} + N(0,q); y_t = c·x_t + N(0,r), y observed."""
    rng = np.random.default_rng(seed)
    dom = Domain([-25, 25], continuous=True)
    xs = [RV(dom, name=f"x{t}") for t in range(T)]

    # simulate observations
    x_true = np.zeros(T)
    ys = np.zeros(T)
    x_true[0] = rng.normal(0, 1)
    for t in range(T):
        if t:
            x_true[t] = a * x_true[t - 1] + rng.normal(0, np.sqrt(q))
        ys[t] = c * x_true[t] + rng.normal(0, np.sqrt(r))

    y_rvs = [RV(dom, value=float(ys[t]), name=f"y{t}") for t in range(T)]
    fs = [F(GaussianPotential([0.0], [[1.0]]), [xs[0]])]
    for t in range(1, T):
        fs.append(F(LinearGaussianPotential(coeff=a, sig=q), [xs[t - 1], xs[t]]))
    for t in range(T):
        fs.append(F(LinearGaussianPotential(coeff=c, sig=r), [xs[t], y_rvs[t]]))
    g = Graph(xs + y_rvs, fs)
    return g, xs, ys


def switching_lds(T: int = 12, seed: int = 0):
    """Hybrid variant: discrete regime s_t ∈ {0,1} selects the drift sign of
    the transition mean; still exact-checkable by enumeration × grid for
    small T."""
    rng = np.random.default_rng(seed)
    dom_x = Domain([-15, 15], continuous=True)
    dom_s = Domain([0, 1])
    xs = [RV(dom_x, name=f"x{t}") for t in range(T)]
    ss = [RV(dom_s, name=f"s{t}") for t in range(T)]
    ys = 0.8 * np.cumsum(rng.normal(0.4, 0.6, T))

    fs = [F(GaussianPotential([0.0], [[1.0]]), [xs[0]])]
    y_rvs = []
    for t in range(T):
        fs.append(F(TablePotential([0.5, 0.5]), [ss[t]]))
        # regime-modulated transition: log φ = −(x_t − x_{t−1} − drift(s))²/(2q)
        if t:
            fs.append(
                F(
                    MLNPotential(
                        lambda arg: -((arg[2] - arg[1] - (2.0 * arg[0] - 1.0) * 0.5)
                                      ** 2) / (2.0 * 0.4),
                        w=1.0,
                        formula_name="switch_transition",
                    ),
                    [ss[t], xs[t - 1], xs[t]],
                )
            )
        y = RV(dom_x, value=float(ys[t]), name=f"y{t}")
        y_rvs.append(y)
        fs.append(F(LinearGaussianPotential(coeff=1.0, sig=0.8), [xs[t], y]))
    g = Graph(xs + ss + y_rvs, fs)
    return g, xs, ss
