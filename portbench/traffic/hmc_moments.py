"""Queries of posterior moments by ``run_hmc`` (``collect="moments"``).

A query is one call of the port's public ``engines/hmc.py::run_hmc`` from
a fresh generator, ending when its moments and diagnostics have been read
to the host. Its work is ``n_chains * n_samples`` kept chain-samples and
``n_warmup + n_samples`` transitions.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def run(fg, mix: dict, gen, n_warmup: int, n_samples: int):
    from lhvi_tpu_torch.engines import hmc

    moments, _, diag = hmc.run_hmc(
        fg, gen, hmc.HMCConfig(**mix["hmc"]), n_chains=mix["n_chains"],
        n_warmup=n_warmup, n_samples=n_samples, collect="moments",
        stream_diag=mix["stream_diag"])
    answer = {k: _host(v) for k, v in moments.items()}
    answer["diag"] = {k: _host(v) for k, v in diag.items()}
    work = dict(samples=mix["n_chains"] * n_samples,
                transitions=n_warmup + n_samples)
    return answer, work


def warm(fg, mix: dict, gen) -> None:
    run(fg, mix, gen, **mix["warm"])


def query(fg, mix: dict, gen):
    return run(fg, mix, gen, mix["n_warmup"], mix["n_samples"])


def finite(answer: dict) -> bool:
    return bool(np.isfinite(answer["mean"]).all()
                and np.isfinite(answer["var"]).all())
