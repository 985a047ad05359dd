"""Faults planted under the ``run_hmc`` queries of ``control_hybrid.py``'s
cells (kinds ``hmc_hybrid`` and ``hmc_moments``), to show that
``correct`` comes out false (``tests/test_portbench_hybrid.py``) and to
read upper limits on the card. Each is a context manager that patches a
public function of the port and restores it.

- ``sweep_frozen``: the Gibbs sweep returns the discrete state it was
  given, so the types never leave their initial draw (the proposal, the
  accept and the adaptation run as before);
- ``state_unchanged``, ``half_unmoved``, ``answer_altered``,
  ``diag_frozen``: ``faults.py``'s for ``run_hmc``.
"""

from __future__ import annotations

from portbench import faults
from portbench.faults import _patched

FAULTS = ("sweep_frozen",) + faults.FAULTS["hmc_moments"]


def plant(fault: str):
    """The context manager planting ``fault`` under ``run_hmc`` queries."""
    from lhvi_tpu_torch.engines import hmc

    if fault == "sweep_frozen":
        return _patched(hmc, "sweep_all",
                        lambda fg, cfg, gen, xc, xd: xd)
    return faults.plant(fault, "hmc_moments")
