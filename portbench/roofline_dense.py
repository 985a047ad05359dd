"""The compulsory work of the dense quadratic leapfrog (K1,
``ops/leapfrog.py``) at given shapes, frozen here so that a later change
of the program does not move the yardstick: the arithmetic of
``chip_smoke.py``'s K1 bound, copied. Peaks and ``bound_s`` are
``roofline.py``'s (H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s f32).

A launch of ``n_steps`` leapfrog steps over ``C`` chains and ``n``
latents on a dense information form (J, h) reads each chain's position
and momentum and writes both back, and reads J, h, the inverse mass and
the step: the bytes. Its operations are its ``n_steps + 1`` products
``x J`` a chain, ``2 n^2`` each; the updates are not counted. At n = 82,
C = 65,536, 8 steps the bound is 0.1184 ms, bound by the operations, as
PERF.md's table of kernels has it.
"""

from __future__ import annotations

from portbench.roofline import F32, bound_s


def k1_work(n_chains: int, n_latent: int, n_steps: int) -> tuple:
    """(compulsory bytes, f32 operations) of one K1 launch."""
    C, n = n_chains, n_latent
    n_bytes = (4 * C * n + n * n + 2 * n + 1) * F32
    return n_bytes, 2 * C * n * n * (n_steps + 1)


def k1_least_s(n_chains: int, n_latent: int, n_steps: int) -> float:
    """K1's least time for one launch."""
    return bound_s(*k1_work(n_chains, n_latent, n_steps))
