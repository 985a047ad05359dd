"""The hybrid friends-smokers MLN, written with the port's relational DSL
from the benchmark's inputs and compiled by the port's ``fast_compile``.

The formulas are written here, not taken from the port's model zoo, so
that the benchmark's model does not move with the program."""

from __future__ import annotations

import time

import numpy as np
import torch


def build(cfg: dict, inputs: dict, device) -> dict:
    """``fg`` (the compiled graph), ``layout`` (the program's index of
    each variable in the reference's order: ``stress`` [N], ``smokes``
    [N] with -1 where observed, ``cancer`` [N], ``friends`` [N, N] with
    -1 on the diagonal) and ``compile_s`` (host seconds of the compile
    call)."""
    from lhvi_tpu_torch.fg.graph import Domain
    from lhvi_tpu_torch.potentials import GaussianPotential, MLNPotential
    from lhvi_tpu_torch.potentials.library import limp
    from lhvi_tpu_torch.relational.fast import fast_compile
    from lhvi_tpu_torch.relational.graph import RelationalGraph

    N = cfg["n_people"]
    people = [f"p{i}" for i in range(N)]
    rg = RelationalGraph()
    rg.lv("X", people)
    rg.lv("Y", people)
    boolean = Domain([0, 1])
    smokes = rg.predicate("smokes", boolean, lvs=["X"])
    cancer = rg.predicate("cancer", boolean, lvs=["X"])
    friends = rg.predicate("friends", boolean, arity=2)
    stress = rg.predicate("stress", Domain(list(cfg["stress_domain"]),
                                           continuous=True), lvs=["X"])
    rg.param_factor(
        MLNPotential(lambda a: limp(a[0], a[1]), w=cfg["w_smokes_cancer"],
                     formula_name="smokes_implies_cancer"),
        [smokes("X"), cancer("X")])
    rg.param_factor(
        MLNPotential(
            lambda a: limp(a[0], a[1] * a[2] + (1.0 - a[1]) * (1.0 - a[2])),
            w=cfg["w_friends"], formula_name="friends_same_smoking"),
        [friends("X", "Y"), smokes("X"), smokes("Y")],
        constraint=lambda s: s["X"] != s["Y"])
    rg.param_factor(GaussianPotential([0.0], [[1.0]]), [stress("X")])
    rg.param_factor(
        MLNPotential(lambda a: a[1] / (1.0 + torch.exp(-2.0 * a[0])),
                     w=cfg["w_stress"], formula_name="stress_drives_smoking"),
        [stress("X"), smokes("X")])
    for i, v in zip(inputs["obs_idx"], inputs["obs_smokes"]):
        rg.observe("smokes", (people[int(i)],), int(v))

    t0 = time.perf_counter()
    fg = fast_compile(rg, device)
    if fg.device.type == "cuda":
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0

    def slot(pred, *args):
        kind, i = fg.meta.loc((pred, tuple(args)))
        return i if kind != "obs" else -1

    friends_idx = np.full((N, N), -1, np.int64)
    for i in range(N):
        for j in range(N):
            if i != j:
                friends_idx[i, j] = slot("friends", people[i], people[j])
    layout = dict(
        stress=np.array([slot("stress", p) for p in people]),
        smokes=np.array([slot("smokes", p) for p in people]),
        cancer=np.array([slot("cancer", p) for p in people]),
        friends=friends_idx)
    return dict(fg=fg, layout=layout, compile_s=compile_s)
