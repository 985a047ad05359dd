"""Queries of posterior moments by ``run_nuts`` (``collect="moments"``).

A query is one call of the port's public ``engines/nuts.py::run_nuts``
from a fresh generator, ending when its moments and diagnostics have been
read to the host. Its work is ``n_chains * n_samples`` kept chain-samples,
``n_warmup + n_samples`` transitions and the leapfrog leaves the chains'
trees integrated, read from the program's counter ``nuts.leaves`` before
and after the query (None where the program keeps no such counter).
"""

from __future__ import annotations

import numpy as np
import torch

LEAVES = "nuts.leaves"


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else v


def _leaves():
    from lhvi_tpu_torch.utils.metrics import counters

    return counters().get(LEAVES)


def run(fg, mix: dict, gen, n_warmup: int, n_samples: int):
    from lhvi_tpu_torch.engines import nuts

    before = _leaves()
    moments, _, diag = nuts.run_nuts(
        fg, gen, nuts.NUTSConfig(**mix["nuts"]), n_chains=mix["n_chains"],
        n_warmup=n_warmup, n_samples=n_samples, collect="moments",
        stream_diag=mix["stream_diag"])
    answer = {k: _host(v) for k, v in moments.items()}
    answer["diag"] = {k: _host(v) for k, v in diag.items()}
    after = _leaves()
    work = dict(samples=mix["n_chains"] * n_samples,
                transitions=n_warmup + n_samples,
                leaves=None if after is None else after - (before or 0))
    return answer, work


def warm(fg, mix: dict, gen) -> None:
    run(fg, mix, gen, **mix["warm"])


def query(fg, mix: dict, gen):
    return run(fg, mix, gen, mix["n_warmup"], mix["n_samples"])


def finite(answer: dict) -> bool:
    return bool(np.isfinite(answer["mean"]).all()
                and np.isfinite(answer["var"]).all())
