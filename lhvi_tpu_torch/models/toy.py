"""Model builders for the PyTorch port (BASELINE.json configs 1–2).

The same code as ``lhvi_tpu/models/toy.py`` with the same numpy RNG, so the
same seed gives the same graph in both packages.
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


def hybrid_chain():
    """3-variable hybrid Gaussian–discrete chain MRF (BASELINE config 1).

    d ∈ {0,1} — x1 — x2, exact marginals checkable on CPU by enumeration ×
    dense quadrature. The d→x1 coupling switches x1's mean to ±1.
    """
    dom_d = Domain([0, 1])
    dom_c = Domain([-10, 10], continuous=True)
    d = RV(dom_d, name="d")
    x1 = RV(dom_c, name="x1")
    x2 = RV(dom_c, name="x2")
    fs = [
        F(TablePotential([0.3, 0.7]), [d]),
        F(
            MLNPotential(
                lambda args: -((args[1] - (2.0 * args[0] - 1.0)) ** 2),
                w=0.5,
                formula_name="switch_mean",
            ),
            [d, x1],
        ),
        F(LinearGaussianPotential(coeff=1.0, sig=1.0), [x1, x2]),
        F(GaussianPotential([0.0], [[4.0]]), [x2]),
    ]
    g = Graph([d, x1, x2], fs)
    return g, (d, x1, x2)


def gaussian_grid(rows: int = 10, cols: int = 10, seed: int = 0,
                  evidence_frac: float = 0.2):
    """Grid Gaussian MRF with observed (evidence) nodes (BASELINE config 2).

    Pairwise attractive linear-Gaussian couplings + unary Gaussians; a
    random fraction of nodes is observed. Walk-summable by construction, so
    GaBP converges and is exact for the marginal means.
    """
    rng = np.random.default_rng(seed)
    dom = Domain([-30, 30], continuous=True)
    rvs = [[RV(dom, name=f"x{r}_{c}") for c in range(cols)] for r in range(rows)]
    fs = []
    for r in range(rows):
        for c in range(cols):
            mu = float(rng.normal(0.0, 2.0))
            fs.append(F(GaussianPotential([mu], [[2.0]]), [rvs[r][c]]))
            if rng.uniform() < evidence_frac:
                rvs[r][c].value = float(rng.normal(mu, 1.0))
    for r in range(rows):
        for c in range(cols):
            if c + 1 < cols:
                fs.append(
                    F(LinearGaussianPotential(coeff=1.0, sig=4.0),
                      [rvs[r][c], rvs[r][c + 1]])
                )
            if r + 1 < rows:
                fs.append(
                    F(LinearGaussianPotential(coeff=1.0, sig=4.0),
                      [rvs[r][c], rvs[r + 1][c]])
                )
    flat = [rv for row in rvs for rv in row]
    g = Graph(flat, fs)
    return g, rvs
