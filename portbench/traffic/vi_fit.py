"""Queries of a variational fit by ``vi.fit``.

A query is one call of the port's public ``engines/vi.py::fit`` from fresh
parameters drawn from a fresh generator, ending when the user's result
(``vi.VIResult``: the parameters, the ELBO trace and the discrete beliefs)
has been read to the host. Its work is ``n_iters`` Adam steps.
"""

from __future__ import annotations

import numpy as np


def run(fg, mix: dict, gen, n_iters: int):
    from lhvi_tpu_torch.engines import vi

    cfg = vi.VIConfig(**{**mix["vi"], "n_iters": n_iters})
    params, trace = vi.fit(fg, gen, cfg)
    res = vi.VIResult(fg, params, trace)
    p = res.params
    answer = dict(log_w=p.log_w, mu=p.mu, log_sigma=p.log_sigma,
                  logits=p.logits, trace_last=float(res.trace[-1]),
                  w=res.w, bd=res.bd)
    return answer, dict(steps=n_iters)


def warm(fg, mix: dict, gen) -> None:
    run(fg, mix, gen, **mix["warm"])


def query(fg, mix: dict, gen):
    return run(fg, mix, gen, mix["vi"]["n_iters"])


def finite(answer: dict) -> bool:
    return bool(np.isfinite(answer["trace_last"])
                and all(np.isfinite(answer[k]).all()
                        for k in ("log_w", "mu", "log_sigma", "logits")))
