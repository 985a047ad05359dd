"""``correct`` for HMC-within-Gibbs queries on the robot-mapping hybrid
MLN.

The reference rebuilds the model from the configuration's weights and the
evidence the benchmark handed to the program and solves it exactly
(forward-backward over the types, the latent depths integrated in closed
form). Compared, over the sampled queries of the window, what a user
reads:

- ``mean_err_max``: the largest |program mean - exact mean| over the
  latent depths;
- ``var_err_max``: the largest |program variance - exact variance| /
  exact variance over the latent depths;
- ``disc_err_max``: the largest |program P(type = v) - exact| over every
  latent type and value;
- ``rhat_gap``: the largest |split-R-hat - 1| over the latent depths and
  over the discrete split-R-hat of the types the program monitors
  (``disc_diag_idx``);
- ``ess_bm_gap``, ``ess_proxy_gap``: as the grid's, over the latent
  depths: |log| of the mean of (mean - exact)^2 ESS / var, which is 0
  where the ESS is the one the exact errors show.
"""

from __future__ import annotations

import numpy as np

ESS_KEYS = {"ess_bm_gap": "ess_bm", "ess_proxy_gap": "ess_proxy"}
GAPS = ["mean_err_max", "var_err_max", "disc_err_max", "rhat_gap",
        *ESS_KEYS]


def _worst(values) -> float:
    v = float(np.max(values)) if np.size(values) else float("nan")
    return v if np.isfinite(v) else float("inf")


def _at(diag: dict, key: str, idx=None) -> np.ndarray:
    """``diag[key]`` (at ``idx``) as float64; nan where it is missing."""
    x = diag.get(key)
    if x is None:
        return np.full(1 if idx is None else len(idx), np.nan)
    x = np.asarray(x, np.float64)
    return x if idx is None else x[idx]


def judge(ref, cfg: dict, inputs: dict, layout, answers, limits: dict,
          rng: np.random.Generator, mix: dict) -> list:
    post = ref.posterior(cfg, inputs)
    mean, var, probs = post["mean"], post["var"], post["type_probs"]
    cont, disc = np.asarray(layout["cont"]), np.asarray(layout["disc"])
    gaps = dict.fromkeys(GAPS, 0.0 if answers else float("inf"))
    with np.errstate(divide="ignore", invalid="ignore"):
        for a in answers:
            m = np.asarray(a["mean"], np.float64)[cont]
            v = np.asarray(a["var"], np.float64)[cont]
            p = np.asarray(a["disc_probs"], np.float64)[disc][:, :3]
            diag = a.get("diag", {})
            rhat = np.concatenate([_at(diag, "rhat", cont),
                                   _at(diag, "rhat_disc")])
            cand = dict(mean_err_max=np.abs(m - mean),
                        var_err_max=np.abs(v - var) / var,
                        disc_err_max=np.abs(p - probs),
                        rhat_gap=np.abs(rhat - 1.0))
            for gap, key in ESS_KEYS.items():
                ratio = np.mean((m - mean) ** 2 * _at(diag, key, cont) / v)
                cand[gap] = np.abs(np.log(ratio))
            for k, c in cand.items():
                gaps[k] = max(gaps[k], _worst(c))
    return [(k, v, limits[k]) for k, v in gaps.items()]
