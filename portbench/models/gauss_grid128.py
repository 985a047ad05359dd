"""The grid Gaussian MRF, built with the port's DSL from the benchmark's
inputs and compiled by the port's ``compile_graph``."""

from __future__ import annotations

import time

import numpy as np
import torch


def build(cfg: dict, inputs: dict, device) -> dict:
    """``fg`` (the compiled graph), ``layout`` (the program's latent index
    of each latent node, in the reference's ascending node order) and
    ``compile_s`` (host seconds of the compile call)."""
    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.fg.graph import F, Domain, Graph, RV
    from lhvi_tpu_torch.potentials import (GaussianPotential,
                                           LinearGaussianPotential)

    R, C = cfg["rows"], cfg["cols"]
    dom = Domain(list(cfg["domain"]), continuous=True)
    rvs = [RV(dom, name=f"x{i}") for i in range(R * C)]
    for i, v in zip(inputs["obs_idx"], inputs["obs_val"]):
        rvs[int(i)].value = float(v)
    fs = [F(GaussianPotential([float(m)], [[cfg["unary_var"]]]), [rv])
          for m, rv in zip(inputs["unary_mean"], rvs)]
    link = LinearGaussianPotential(coeff=cfg["coeff"], sig=cfg["sig"])
    idx = np.arange(R * C).reshape(R, C)
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])):
        fs += [F(link, [rvs[int(i)], rvs[int(j)]])
               for i, j in zip(a.ravel(), b.ravel())]
    g = Graph(rvs, fs)
    t0 = time.perf_counter()
    fg = compile_graph(g, device)
    if fg.device.type == "cuda":
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    lat = np.ones(R * C, bool)
    lat[inputs["obs_idx"]] = False
    layout = np.array([fg.meta.loc(rvs[i])[1] for i in np.flatnonzero(lat)])
    return dict(fg=fg, layout=layout, compile_s=compile_s)
