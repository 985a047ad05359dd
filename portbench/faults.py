"""Faults planted in the program underneath the timed path, to show that
``correct`` comes out false (``tests/test_portbench_run.py``) and to read
upper limits on the card (``control.py``). Each is a context manager
that patches a public function of the port and restores it.

- ``state_unchanged``: a step that returns its state unchanged (the HMC
  transition; the Adam update);
- ``half_unmoved``: half of the batch left out (the HMC transition moves
  the first half of the chains only; the ELBO sums the first half of each
  bucket's factor rows, doubled);
- ``answer_altered``: an answer altered where it is produced (one
  posterior mean moved by one; the fit's last ELBO by 1%);
- ``diag_frozen`` (samplers): the streamed diagnostics' update returns its
  accumulators unchanged, so R-hat and the ESS are read from no draws.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

COMMON = ("state_unchanged", "half_unmoved", "answer_altered")
FAULTS = {"hmc_moments": COMMON + ("diag_frozen",), "vi_fit": COMMON}


@contextlib.contextmanager
def _patched(obj, name: str, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def plant(fault: str, kind: str):
    """The context manager planting ``fault`` under a query ``kind``."""
    from lhvi_tpu_torch.engines import hmc, vi

    if kind == "hmc_moments":
        orig_t, orig_run = hmc.hmc_transition, hmc.run_hmc
        if fault == "state_unchanged":
            def trans(fg, cfg, state, gen, adapt, gate=None, shard=None):
                return state, torch.zeros(state.xc.shape[0],
                                          device=state.xc.device)
            return _patched(hmc, "hmc_transition", trans)
        if fault == "half_unmoved":
            def trans(fg, cfg, state, gen, adapt, gate=None, shard=None):
                new, acc = orig_t(fg, cfg, state, gen, adapt, gate, shard)
                h = state.xc.shape[0] // 2
                return new._replace(
                    xc=torch.cat([new.xc[:h], state.xc[h:]]),
                    xd=torch.cat([new.xd[:h], state.xd[h:]])), acc
            return _patched(hmc, "hmc_transition", trans)
        if fault == "answer_altered":
            def run(*a, **kw):
                moments, x, diag = orig_run(*a, **kw)
                mean = moments["mean"].clone()
                mean[0] += 1.0
                return dict(moments, mean=mean), x, diag
            return _patched(hmc, "run_hmc", run)
        if fault == "diag_frozen":
            return _patched(hmc, "_stream_diag_update",
                            lambda sd, *a, **kw: sd)
    if kind == "vi_fit":
        if fault == "state_unchanged":
            return _patched(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        if fault == "half_unmoved":
            orig_b = vi._bucket_expected_logpot

            def bucket(fg, b, params, bd, plan):
                n = b.scale.shape[0]
                keep = (torch.arange(n, device=b.scale.device) < n // 2)
                scale = torch.where(keep, 2.0 * b.scale,
                                    torch.zeros_like(b.scale))
                return orig_b(fg, dataclasses.replace(b, scale=scale),
                              params, bd, plan)
            return _patched(vi, "_bucket_expected_logpot", bucket)
        if fault == "answer_altered":
            orig_fit = vi.fit

            def fit(*a, **kw):
                params, trace = orig_fit(*a, **kw)
                trace = trace.clone()
                trace[-1] = trace[-1] * 1.01
                return params, trace
            return _patched(vi, "fit", fit)
    raise KeyError(f"no fault {fault!r} for queries of kind {kind!r}")
