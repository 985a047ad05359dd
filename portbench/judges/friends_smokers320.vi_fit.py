"""``correct`` for variational fits of the friends-smokers MLN.

The reference grounds the model itself from the inputs the benchmark
handed to the program and reads the returned parameters through the
program's variable index (``layout``). Compared, over the sampled queries:

- ``elbo_gap``: |the fit's last ELBO - the reference's ELBO at the
  returned parameters| / |the reference's|. The trace's last entry is the
  ELBO before the last Adam step, so one step's change is in the gap;
- ``marginal_gap``: the largest |P(x = 1) the user reads - the reference's
  mixture marginal of the returned parameters| over every binary latent;
- ``cancer_gap``: the largest |P(cancer = 1) the user reads - its closed
  form| over the observed people (sigma(w) for a smoker, 1/2 otherwise):
  the fit has to have moved the beliefs to the exact conditionals.

An answer may carry ``marginals`` (reference layout) in place of ``w`` and
``bd``: the control reads the reference's own there.
"""

from __future__ import annotations

import numpy as np


def to_reference(answer: dict, layout: dict) -> dict:
    """The returned parameters in the reference's layout."""
    lg = np.asarray(answer["logits"])[..., :2]
    st = layout["stress"]
    return dict(
        log_w=np.asarray(answer["log_w"]),
        mu=np.asarray(answer["mu"])[:, st],
        log_sigma=np.asarray(answer["log_sigma"])[:, st],
        smokes_logits=lg[:, np.maximum(layout["smokes"], 0)],
        cancer_logits=lg[:, layout["cancer"]],
        friends_logits=lg[:, np.maximum(layout["friends"], 0)])


def user_marginals(answer: dict, layout: dict) -> dict:
    """P(x = 1) as the user reads it (mixture weights times beliefs)."""
    p = np.einsum("k,kv->v", np.asarray(answer["w"], np.float64),
                  np.asarray(answer["bd"], np.float64)[:, :, 1])
    return {k: p[np.maximum(layout[k], 0)]
            for k in ("smokes", "cancer", "friends")}


def judge(ref, cfg: dict, inputs: dict, layout, answers, limits: dict,
          rng: np.random.Generator, mix: dict) -> list:
    n_quad = mix["vi"]["n_quad"]
    N = cfg["n_people"]
    lat_s = np.ones(N, bool)
    lat_s[inputs["obs_idx"]] = False
    off = ~np.eye(N, dtype=bool)
    closed = ref.cancer_closed_form(cfg, inputs)
    gaps = dict(elbo_gap=0.0, marginal_gap=0.0, cancer_gap=0.0)
    if not answers:
        gaps = dict.fromkeys(gaps, float("inf"))
    for a in answers:
        q = to_reference(a, layout)
        e = ref.elbo(cfg, inputs, q, n_quad)
        mine = a.get("marginals") or user_marginals(a, layout)
        theirs = ref.marginals(q)
        diffs = np.concatenate([
            np.abs(mine["smokes"] - theirs["smokes"])[lat_s],
            np.abs(mine["cancer"] - theirs["cancer"]),
            np.abs(mine["friends"] - theirs["friends"])[off]])
        cand = dict(
            elbo_gap=abs(a["trace_last"] - e) / abs(e),
            marginal_gap=diffs.max(),
            cancer_gap=np.abs(mine["cancer"][inputs["obs_idx"]]
                              - closed).max())
        for k, v in cand.items():
            gaps[k] = max(gaps[k], float(v) if np.isfinite(v) else np.inf)
    return [(k, v, limits[k]) for k, v in gaps.items()]
