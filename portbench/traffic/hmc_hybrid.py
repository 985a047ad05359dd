"""Queries of posterior moments and discrete marginals by ``run_hmc``
(``collect="moments"``) on a hybrid model: HMC-within-Gibbs.

A query is ``hmc_moments``'s: one call of the port's public
``engines/hmc.py::run_hmc`` from a fresh generator, ending when its
moments, discrete marginals and diagnostics have been read to the host.
Its work is ``n_chains * n_samples`` kept chain-samples, ``n_warmup +
n_samples`` transitions, and three counts the program keeps, read before
and after the query (each None where the program keeps no such counter):
``sweep_classes`` (``hmc.sweep_classes``, the colour classes the Gibbs
sweeps drew), ``sweep_rows`` (``hmc.sweep_rows``, the factor rows times
candidate values they evaluated) and ``k5_launches`` (``ops.k5.launches``,
the fused non-quadratic proposals).
"""

from __future__ import annotations

import numpy as np
import torch

COUNTERS = {"sweep_classes": "hmc.sweep_classes",
            "sweep_rows": "hmc.sweep_rows",
            "k5_launches": "ops.k5.launches"}


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _counts():
    from lhvi_tpu_torch.utils.metrics import counters

    now = counters()
    return {k: now.get(name) for k, name in COUNTERS.items()}


def run(fg, mix: dict, gen, n_warmup: int, n_samples: int):
    from lhvi_tpu_torch.engines import hmc

    before = _counts()
    moments, _, diag = hmc.run_hmc(
        fg, gen, hmc.HMCConfig(**mix["hmc"]), n_chains=mix["n_chains"],
        n_warmup=n_warmup, n_samples=n_samples, collect="moments",
        stream_diag=mix["stream_diag"])
    answer = {k: _host(v) for k, v in moments.items()}
    answer["diag"] = {k: _host(v) for k, v in diag.items()}
    after = _counts()
    work = dict(samples=mix["n_chains"] * n_samples,
                transitions=n_warmup + n_samples)
    work.update({k: None if after[k] is None else after[k] - (before[k] or 0)
                 for k in COUNTERS})
    return answer, work


def warm(fg, mix: dict, gen) -> None:
    run(fg, mix, gen, **mix["warm"])


def query(fg, mix: dict, gen):
    return run(fg, mix, gen, mix["n_warmup"], mix["n_samples"])


def finite(answer: dict) -> bool:
    return bool(np.isfinite(answer["mean"]).all()
                and np.isfinite(answer["var"]).all()
                and np.isfinite(answer["disc_probs"]).all())
