"""Brute-force exact posterior oracle for small hybrid MRFs (PyTorch port of
``lhvi_tpu/utils/oracle.py``).

Enumerates all discrete-latent assignments × a dense grid over continuous
latents and integrates numerically, in numpy. It does NOT go through the
compiled IR: each factor is evaluated straight from the host graph with
its potential's ``kernel`` on CPU tensors (f32, as the reference's
kernels), so it is an independent check on the compiler and runs where
JAX is not installed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lhvi_tpu_torch.fg.graph import Graph, RV


class ExactPosterior:
    """Holds the normalized joint over enumerated/gridded latent states."""

    def __init__(self, g: Graph, cont_grid: int = 201):
        g.init_nb()
        self.g = g
        self.cont = [rv for rv in g.rvs if not rv.observed and rv.domain.continuous]
        self.disc = [rv for rv in g.rvs if not rv.observed and not rv.domain.continuous]

        axes = []
        self.cont_axes: Dict[int, np.ndarray] = {}
        for rv in self.cont:
            grid = np.linspace(rv.domain.low, rv.domain.high, cont_grid)
            self.cont_axes[id(rv)] = grid
            axes.append(grid)
        for rv in self.disc:
            axes.append(np.arange(rv.domain.size))

        nc = len(self.cont)
        if axes:
            mesh = np.meshgrid(*axes, indexing="ij")
            n_states = int(mesh[0].size)
            states_c = (np.stack([m.reshape(-1) for m in mesh[:nc]], -1)
                        if nc else np.zeros((n_states, 0)))
            states_d = (np.stack([m.reshape(-1).astype(np.int64)
                                  for m in mesh[nc:]], -1)
                        if len(mesh) > nc else np.zeros((n_states, 0), np.int64))
        else:
            states_c = np.zeros((1, 0))
            states_d = np.zeros((1, 0), np.int64)
        self.states_c, self.states_d = states_c, states_d

        n = states_c.shape[0]
        logp = np.zeros(n)
        loc_c = {id(rv): i for i, rv in enumerate(self.cont)}
        loc_d = {id(rv): i for i, rv in enumerate(self.disc)}
        for f in g.factors:
            pattern = tuple(rv.domain.continuous for rv in f.nb)
            xc_cols, xdi_cols, xdv_cols = [], [], []
            for rv, is_cont in zip(f.nb, pattern):
                if is_cont:
                    if rv.observed:
                        xc_cols.append(np.full(n, float(rv.value)))
                    else:
                        xc_cols.append(states_c[:, loc_c[id(rv)]])
                elif rv.observed:
                    vi = rv.domain.value_index(rv.value)
                    xdi_cols.append(np.full(n, vi, np.int64))
                    xdv_cols.append(np.full(n, float(rv.value)))
                else:
                    idx = states_d[:, loc_d[id(rv)]]
                    xdi_cols.append(idx)
                    xdv_cols.append(np.asarray(rv.domain.values)[idx])

            def stack(cols, dtype):
                a = (np.stack(cols, -1) if cols
                     else np.zeros((n, 0), dtype))
                return torch.from_numpy(np.ascontiguousarray(a, dtype))

            params = {k: torch.from_numpy(np.asarray(v)[None].copy())
                      for k, v in f.potential.param_arrays().items()}
            with torch.no_grad():
                lp = f.potential.kernel(pattern)(
                    params, stack(xc_cols, np.float32),
                    stack(xdi_cols, np.int64), stack(xdv_cols, np.float32))
            logp += lp.numpy().astype(np.float64)

        m = logp.max()
        w = np.exp(logp - m)
        self.w = w / w.sum()
        # Riemann log-normalizer: counting measure on discrete values,
        # Lebesgue (grid spacing) on continuous dims
        log_dx = sum(
            float(np.log(ax[1] - ax[0])) if len(ax) > 1 else 0.0
            for ax in (self.cont_axes[id(rv)] for rv in self.cont)
        )
        self.log_z = float(m + np.log(w.sum()) + log_dx)

    # --- queries ----------------------------------------------------------
    def mean(self, rv: RV) -> float:
        i = [id(r) for r in self.cont].index(id(rv))
        return float(np.sum(self.w * self.states_c[:, i]))

    def var(self, rv: RV) -> float:
        i = [id(r) for r in self.cont].index(id(rv))
        m = self.mean(rv)
        return float(np.sum(self.w * (self.states_c[:, i] - m) ** 2))

    def disc_marginal(self, rv: RV) -> np.ndarray:
        i = [id(r) for r in self.disc].index(id(rv))
        out = np.zeros(rv.domain.size)
        np.add.at(out, self.states_d[:, i], self.w)
        return out

    def density(self, x, rv: RV):
        """Exact marginal density of continuous ``rv`` at ``x``: grid masses
        over trapezoid cell widths, linearly interpolated."""
        i = [id(r) for r in self.cont].index(id(rv))
        grid = self.cont_axes[id(rv)]
        gi = np.searchsorted(grid, self.states_c[:, i])
        mass = np.zeros(len(grid))
        np.add.at(mass, np.clip(gi, 0, len(grid) - 1), self.w)
        dens = mass / np.gradient(grid)
        out = np.interp(np.asarray(x, np.float64), grid, dens)
        return float(out) if np.isscalar(x) or np.ndim(x) == 0 else out

    def map_state(self):
        """Most probable enumerated state (dict rv -> value)."""
        i = int(np.argmax(self.w))
        out = {}
        for j, rv in enumerate(self.cont):
            out[rv] = float(self.states_c[i, j])
        for j, rv in enumerate(self.disc):
            out[rv] = rv.domain.values[self.states_d[i, j]]
        return out
