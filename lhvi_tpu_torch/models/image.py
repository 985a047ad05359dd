"""Image-denoising MRF for the PyTorch port (the same code as
``lhvi_tpu/models/image.py``, with the same numpy RNG).

Latent pixel intensities with observed noisy measurements (unary image-node
potentials) and robust truncated smoothness on the 4-neighborhood (image-
edge potentials).
"""

from __future__ import annotations

import numpy as np

from lhvi_tpu_torch.fg.graph import Domain, F, Graph, RV
from lhvi_tpu_torch.potentials import ImageEdgePotential, ImageNodePotential


def denoise_grid(
    rows: int = 12,
    cols: int = 12,
    noise: float = 0.3,
    alpha: float = 0.0625,
    cap: float = 0.4,
    scale: float = 0.05,
    seed: int = 0,
):
    """Noisy step-image denoising MRF.

    Ground truth is a two-level step image; observations add N(0, noise²).
    Returns (graph, pixel_rvs [rows][cols], truth, observed).
    """
    rng = np.random.default_rng(seed)
    truth = np.zeros((rows, cols))
    truth[:, cols // 2 :] = 1.0
    obs = truth + rng.normal(0.0, noise, truth.shape)

    dom = Domain([-1.0, 2.0], continuous=True)
    rvs = [[RV(dom, name=f"px{r}_{c}") for c in range(cols)] for r in range(rows)]
    fs = []
    node_pot = ImageNodePotential(alpha=alpha)
    edge_pot = ImageEdgePotential(distance_cap=cap, scale=scale)
    for r in range(rows):
        for c in range(cols):
            y = RV(dom, value=float(obs[r, c]), name=f"obs{r}_{c}")
            fs.append(F(node_pot, [rvs[r][c], y]))
            if c + 1 < cols:
                fs.append(F(edge_pot, [rvs[r][c], rvs[r][c + 1]]))
            if r + 1 < rows:
                fs.append(F(edge_pot, [rvs[r][c], rvs[r + 1][c]]))
    flat = [rv for row in rvs for rv in row]
    for f in fs:
        for rv in f.nb:
            if rv not in flat:
                flat.append(rv)
    g = Graph(flat, fs)
    return g, rvs, truth, obs
