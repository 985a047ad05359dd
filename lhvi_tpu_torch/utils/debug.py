"""Debugging aids (PyTorch port of ``lhvi_tpu/utils/debug.py``).

Runs are replayable by construction (every draw flows through an explicit
``torch.Generator``), and numerical faults can be trapped where they are
made. The reference sets ``jax_debug_nans``, which traps a NaN produced by
any jitted operation. PyTorch has no such switch for forward code:
``torch.autograd.set_detect_anomaly`` covers backward passes only. So the
forward side is a module-level flag that the engines' steps test: each
HMC and NUTS transition (``hmc.hmc_transition``, ``nuts.nuts_transition``),
each SMC temperature and each VI optimizer step calls
:func:`check_nan` on what it produced, which raises
``FloatingPointError`` naming the tensor.

The check reads a flag back from the device every call, so it
synchronizes the host with the card: it is for debugging only, and costs
nothing while it is off.
"""

from __future__ import annotations

import contextlib

import torch

_ENABLED = False


def nan_checks_enabled() -> bool:
    return _ENABLED


def enable_nan_checks(enable: bool = True) -> None:
    """Trap NaN production in the engines' steps (forward, through
    :func:`check_nan`) and in autograd's backward passes (anomaly
    detection). Heavy: debugging only."""
    global _ENABLED
    _ENABLED = bool(enable)
    torch.autograd.set_detect_anomaly(_ENABLED)


@contextlib.contextmanager
def nan_checks():
    """Context-managed version of :func:`enable_nan_checks`."""
    prev = _ENABLED
    enable_nan_checks(True)
    try:
        yield
    finally:
        enable_nan_checks(prev)


def check_nan(where: str, **tensors) -> None:
    """Raise ``FloatingPointError`` if any of ``tensors`` holds a NaN, when
    the checks are on (a device read each); a no-op otherwise."""
    if not _ENABLED:
        return
    for name, t in tensors.items():
        if t is not None and t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"NaN in {name} ({where})")
