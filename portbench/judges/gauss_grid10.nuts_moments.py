"""``correct`` for NUTS posterior-moment queries on BASELINE config 2's
10 x 10 grid.

The reference rebuilds the information form from the inputs the benchmark
handed to the program and solves it exactly (dense, float64). Compared,
over the sampled queries of the window, the moments and the streamed
diagnostics a user reads, over all 82 latents:

- ``mean_err_max``: the largest |program mean - exact mean|;
- ``var_err_max``: the largest |program variance - exact variance| /
  exact variance;
- ``rhat_gap``: the largest |split-R-hat - 1|;
- ``ess_bm_gap``, ``ess_proxy_gap``: whether an ESS says how far the mean
  lies from the exact one. With the right ESS, (mean - exact)^2 ESS / var
  averages 1 over the latents; the gap is |log| of that average, the
  largest over the queries.
"""

from __future__ import annotations

import numpy as np

ESS_KEYS = {"ess_bm_gap": "ess_bm", "ess_proxy_gap": "ess_proxy"}


def _worst(values) -> float:
    v = float(np.max(values))
    return v if np.isfinite(v) else float("inf")


def judge(ref, cfg: dict, inputs: dict, layout, answers, limits: dict,
          rng: np.random.Generator, mix: dict) -> list:
    mean, var = ref.posterior(cfg, inputs)
    gaps = dict.fromkeys(["mean_err_max", "var_err_max", "rhat_gap",
                          *ESS_KEYS], 0.0 if answers else float("inf"))
    with np.errstate(divide="ignore", invalid="ignore"):
        for a in answers:
            m = np.asarray(a["mean"], np.float64)[layout]
            v = np.asarray(a["var"], np.float64)[layout]
            diag = {k: np.asarray(d, np.float64)[layout]
                    for k, d in a.get("diag", {}).items()
                    if k in ("rhat", *ESS_KEYS.values())}
            cand = dict(mean_err_max=np.abs(m - mean),
                        var_err_max=np.abs(v - var) / var,
                        rhat_gap=np.abs(diag.get("rhat", np.nan) - 1.0))
            for gap, key in ESS_KEYS.items():
                ratio = np.mean((m - mean) ** 2 * diag.get(key, np.nan) / v)
                cand[gap] = np.abs(np.log(ratio))
            for k, c in cand.items():
                gaps[k] = max(gaps[k], _worst(c))
    return [(k, v, limits[k]) for k, v in gaps.items()]
