"""The robot-mapping hybrid MLN, built with the port's relational DSL
(``models/relational.py::robot_map`` at the configuration's weights) on
the benchmark's evidence, grounded and compiled by the port's
``compile_graph``: 97 latent types through the planned Gibbs sweep and
14 latent depths through the non-quadratic proposal (K5 with
``fused_logpot``)."""

from __future__ import annotations

import time

import torch


def build(cfg: dict, inputs: dict, device) -> dict:
    """``fg``, ``layout`` (``cont``: the program's continuous index of
    each latent depth, ``disc``: its discrete index of each latent type,
    both in the reference's ascending segment order) and ``compile_s``;
    raises where the compiled graph's sizes are not the configuration's."""
    from lhvi_tpu_torch import compile_graph
    from lhvi_tpu_torch.models.relational import robot_map

    seg = lambda i: (f"s{int(i)}",)  # noqa: E731
    ev = {("type", seg(i)): int(v)
          for i, v in zip(inputs["type_obs_idx"], inputs["type_obs_val"])}
    ev.update({("depth", seg(i)): float(v) for i, v in
               zip(inputs["depth_obs_idx"], inputs["depth_obs_val"])})
    g, index = robot_map(cfg["n_segments"], evidence=ev,
                         w_type_depth=cfg["w_type_depth"],
                         w_smooth=cfg["w_smooth"],
                         w_neighbor=cfg["w_neighbor"]).ground()
    t0 = time.perf_counter()
    fg = compile_graph(g, device)
    if fg.device.type == "cuda":
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    if (fg.n_cont, fg.n_disc) != (cfg["n_latent_depths"],
                                  cfg["n_latent_types"]):
        raise ValueError(f"robot_map100: {fg.n_cont} latent depths and "
                         f"{fg.n_disc} latent types compiled, the "
                         "configuration states "
                         f"{cfg['n_latent_depths']} and "
                         f"{cfg['n_latent_types']}")
    n = cfg["n_segments"]
    typed = set(int(i) for i in inputs["type_obs_idx"])
    deep = set(int(i) for i in inputs["depth_obs_idx"])
    layout = dict(
        cont=[fg.meta.loc(index[("depth", seg(i))])[1] for i in range(n)
              if i not in deep],
        disc=[fg.meta.loc(index[("type", seg(i))])[1] for i in range(n)
              if i not in typed])
    return dict(fg=fg, layout=layout, compile_s=compile_s)
