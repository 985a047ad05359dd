"""Faults planted under NUTS moment queries (kind ``nuts_moments``), the
counterparts of ``faults.py``'s for ``run_nuts``: to show that ``correct``
comes out false (``tests/test_portbench_nuts.py``) and to read upper limits
on the card (``control_nuts.py``). Each is a context manager that patches
a public function of the port and restores it.

- ``state_unchanged``: the NUTS transition returns the state it was given
  (its trajectory and adaptation run and are dropped);
- ``half_unmoved``: the transition moves the first half of the chains
  only;
- ``answer_altered``: one posterior mean of ``run_nuts``'s answer moved by
  one;
- ``diag_frozen``: the streamed diagnostics' update returns its
  accumulators unchanged, so R-hat and the ESS are read from no draws.
"""

from __future__ import annotations

import torch

from portbench.faults import _patched

KIND = "nuts_moments"
FAULTS = ("state_unchanged", "half_unmoved", "answer_altered", "diag_frozen")


def plant(fault: str):
    """The context manager planting ``fault`` under NUTS queries."""
    from lhvi_tpu_torch.engines import hmc, nuts

    orig_t, orig_run = nuts.nuts_transition, nuts.run_nuts
    if fault == "state_unchanged":
        def trans(fg, cfg, state, *a, **kw):
            return state, orig_t(fg, cfg, state, *a, **kw)[1]
        return _patched(nuts, "nuts_transition", trans)
    if fault == "half_unmoved":
        def trans(fg, cfg, state, *a, **kw):
            new, stats = orig_t(fg, cfg, state, *a, **kw)
            h = state.xc.shape[0] // 2
            return new._replace(
                xc=torch.cat([new.xc[:h], state.xc[h:]]),
                xd=torch.cat([new.xd[:h], state.xd[h:]])), stats
        return _patched(nuts, "nuts_transition", trans)
    if fault == "answer_altered":
        def run(*a, **kw):
            moments, x, diag = orig_run(*a, **kw)
            mean = moments["mean"].clone()
            mean[0] += 1.0
            return dict(moments, mean=mean), x, diag
        return _patched(nuts, "run_nuts", run)
    if fault == "diag_frozen":
        return _patched(hmc, "_stream_diag_update", lambda sd, *a, **kw: sd)
    raise KeyError(f"no fault {fault!r} for queries of kind {KIND!r}")

