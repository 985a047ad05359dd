"""Relational model zoo for the PyTorch port: friends-smokers (hybrid MLN)
and the robot-mapping HMLN.

The same code as ``lhvi_tpu/models/relational.py`` with the same numpy
RNG, so one seed gives one graph in both packages. The one formula that
called ``jnp.exp`` (``stress_drives_smoking``) calls ``torch.exp`` here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lhvi_tpu_torch.fg.graph import Domain
from lhvi_tpu_torch.potentials import (
    GaussianPotential,
    MLNPotential,
    QuadraticPotential,
    TablePotential,
    limp,
)
from lhvi_tpu_torch.relational.graph import RelationalGraph


def friends_smokers(
    n_people: int = 10,
    hybrid: bool = True,
    evidence: Dict = None,
    w_smokes_cancer: float = 1.2,
    w_friends: float = 1.1,
):
    """Hybrid friends-smokers MLN.

    Predicates: smokes(P), cancer(P) boolean; friends(P,Q) boolean for
    P≠Q; and, in the hybrid variant, stress(P) continuous with a Gaussian
    prior and a soft link stress→smokes.

    Rules:
      w1: smokes(X) ⇒ cancer(X)
      w2: friends(X,Y) ⇒ (smokes(X) ⇔ smokes(Y))
      w3 (hybrid): high stress(X) ⇒ smokes(X)
    """
    rg = RelationalGraph()
    people = [f"p{i}" for i in range(n_people)]
    rg.lv("X", people)
    rg.lv("Y", people)

    boolean = Domain([0, 1])
    smokes = rg.predicate("smokes", boolean, lvs=["X"])
    cancer = rg.predicate("cancer", boolean, lvs=["X"])
    friends = rg.predicate("friends", boolean, arity=2)

    rg.param_factor(
        MLNPotential(lambda a: limp(a[0], a[1]), w=w_smokes_cancer,
                     formula_name="smokes_implies_cancer"),
        [smokes("X"), cancer("X")],
    )
    rg.param_factor(
        MLNPotential(
            lambda a: limp(a[0], a[1] * a[2] + (1.0 - a[1]) * (1.0 - a[2])),
            w=w_friends,
            formula_name="friends_same_smoking",
        ),
        [friends("X", "Y"), smokes("X"), smokes("Y")],
        constraint=lambda s: s["X"] != s["Y"],
    )
    if hybrid:
        stress = rg.predicate("stress", Domain([-5, 5], continuous=True),
                              lvs=["X"])
        rg.param_factor(
            GaussianPotential([0.0], [[1.0]]), [stress("X")]
        )
        rg.param_factor(
            MLNPotential(
                lambda a: a[1] / (1.0 + torch.exp(-2.0 * a[0])),
                w=1.0,
                formula_name="stress_drives_smoking",
            ),
            [stress("X"), smokes("X")],
        )
    if evidence:
        rg.observe_many(evidence)
    return rg


def robot_map(
    n_segments: int = 24,
    evidence: Dict = None,
    w_type_depth: float = 4.0,
    w_smooth: float = 0.5,
    w_neighbor: float = 0.6,
):
    """Robot-mapping hybrid MLN.

    A hallway laser scan is split into segments ``s0..s{n-1}``; each
    segment has a discrete ``type`` in {0=wall, 1=door, 2=other} and a
    continuous ``depth`` — the signed offset of the segment from the
    fitted wall line (doors are recessed, clutter protrudes).

    Rules (soft, weighted):
      1. per-segment type prior (walls most common)
      2. weak Gaussian prior on depth
      3. type ⇒ expected depth: −w·(depth(s) − μ_type)², μ = (0, 0.8, −0.5)
      4. adjacent segments prefer the same type (3×3 agreement table)
      5. adjacent depths are smooth: −w·(depth(s) − depth(s+1))²
    """
    rg = RelationalGraph()
    segs = [f"s{i}" for i in range(n_segments)]
    rg.lv("S", segs)
    rg.lv("T", segs)

    type_dom = Domain([0, 1, 2])
    depth_dom = Domain([-3, 3], continuous=True)
    seg_type = rg.predicate("type", type_dom, lvs=["S"])
    depth = rg.predicate("depth", depth_dom, lvs=["S"])

    rg.param_factor(TablePotential([0.6, 0.25, 0.15]), [seg_type("S")])
    rg.param_factor(GaussianPotential([0.0], [[4.0]]), [depth("S")])
    rg.param_factor(
        MLNPotential(
            # μ(type): wall → 0.0, door → 0.8, other → −0.5
            lambda a: -((a[1] - (0.8 * (a[0] == 1.0) - 0.5 * (a[0] == 2.0)))
                        ** 2),
            w=w_type_depth,
            formula_name="type_sets_depth",
        ),
        [seg_type("S"), depth("S")],
    )

    def adjacent(sub):
        return int(sub["T"][1:]) == int(sub["S"][1:]) + 1

    rg.param_factor(
        TablePotential(np.exp(w_neighbor * np.eye(3)).tolist()),
        [seg_type("S"), seg_type("T")],
        constraint=adjacent,
    )
    rg.param_factor(
        QuadraticPotential(
            [[-w_smooth, w_smooth], [w_smooth, -w_smooth]], [0.0, 0.0]
        ),
        [depth("S"), depth("T")],
        constraint=adjacent,
    )
    if evidence:
        rg.observe_many(evidence)
    return rg


def robot_scan_evidence(
    n_segments: int = 24,
    seed: int = 0,
    depth_miss_every: int = 7,
    n_type_labels: int = 3,
    noise: float = 0.12,
):
    """Synthesize a hallway scan as an MLN evidence file (text) for
    ``relational.data.load_evidence``.

    Layout: mostly walls, a door every 6 segments, clutter every 11.
    Returns ``(evidence_text, true_types)`` — true_types for scoring.
    """
    rng = np.random.default_rng(seed)
    mus = np.array([0.0, 0.8, -0.5])
    types = np.zeros(n_segments, np.int64)
    types[3::6] = 1
    types[7::11] = 2
    lines = [
        "# synthetic hallway laser scan (robot-mapping HMLN experiment)",
        "# depth(s) = signed offset from the fitted wall line",
    ]
    labeled = set(int(i) for i in
                  np.linspace(0, n_segments - 1, n_type_labels).astype(int))
    for i in range(n_segments):
        if i in labeled:
            lines.append(f"type(s{i}) = {int(types[i])}")
        if i % depth_miss_every != depth_miss_every - 1:
            d = mus[types[i]] + noise * rng.standard_normal()
            lines.append(f"depth(s{i}) = {d:.4f}")
    return "\n".join(lines) + "\n", types
