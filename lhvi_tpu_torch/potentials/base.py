"""Potential base protocol + kernel conventions (PyTorch port).

Mirrors ``lhvi_tpu/potentials/base.py``: every potential *type* contributes
one batched ``log φ`` function over stacked parameter tensors for a whole
bucket of same-type factors; the host-side ``Potential`` objects only
*declare* parameters (numpy), so ``bucket_key``/``param_arrays`` are the
reference's exactly.

Kernel signature (one kernel per bucket)::

    log_pot(params, xc, xdi, xdv) -> f32 tensor [...]

- ``params``: dict of tensors; each leaf is broadcastable against the batch
  dims of ``xc`` (the compiler stacks per-factor params along axis 0 and
  the batched gather inserts a leading chain axis).
- ``xc``: f32 ``[..., ac]`` continuous argument slots (original factor
  argument order restricted to continuous slots).
- ``xdi``: int ``[..., ad]`` discrete argument slots as *indices* into each
  slot's domain (used by table lookups).
- ``xdv``: f32 ``[..., ad]`` the same discrete slots as domain *values*
  (used by formula/feature potentials).

``kernel(pattern)`` receives the bucket's continuity pattern — a tuple of
bools, one per original argument slot, True = continuous — so potentials
whose semantics depend on argument order across types (MLN formulas) can
reassemble the original tuple.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np


class Potential:
    """Host-side potential declaration.

    Subclasses define:
      - ``bucket_key()``: hashable key; factors sharing a key (plus the same
        continuity/evidence pattern, added by the compiler) are batched into
        one bucket and evaluated by one kernel instance.
      - ``param_arrays()``: dict of numpy arrays (stacked along axis 0 by the
        compiler across the bucket).
      - ``kernel(pattern)``: the batched log-potential function.
      - ``kernel_planar(pattern)`` (optional): the factor-minor form the
        fused log-potential kernel traces.
      - ``symmetric``: True if invariant to argument permutation (read by
        the lifting pass).
      - ``color_key()``: the identity that seeds factor colors in color
        refinement (``lift/color.py``).
    """

    symmetric: bool = False

    def bucket_key(self) -> Hashable:
        raise NotImplementedError

    def param_arrays(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def kernel(self, pattern: Tuple[bool, ...]) -> Callable:
        raise NotImplementedError

    def color_key(self) -> Hashable:
        """Identity used to seed factor colors in color refinement."""
        return (self.bucket_key(), _np_key(self.param_arrays()))

    def kernel_planar(self, pattern: Tuple[bool, ...]):
        """Optional factor-minor kernel: ``log_pot(params, slots)`` where
        ``slots`` is a list of same-shaped ``[..., F]`` tensors, one per
        argument in order (continuous values / discrete domain values),
        and every ``params`` leaf is 2D ``[k, F]`` — the per-factor
        components flattened row-major into ``k`` rows, factors on the
        minor axis, read with static row slices (``leaf[i:i+1]``).

        The fused log-potential kernel (K5, ``ops/logpot.py``) traces this
        function once on the host into a tape (``ops/logpot_tape.py``), so
        it must be straight-line arithmetic over its arguments. Return
        None (default) to opt out: such a model runs on the autograd
        path, and K5 (``fused_logpot=True`` on the card) refuses it.
        """
        return None


def _np_key(d: Dict[str, np.ndarray]) -> Hashable:
    return tuple((k, v.shape, v.tobytes()) for k, v in sorted(d.items()))
