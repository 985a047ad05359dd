"""The yardstick's peaks, the compulsory work of the banded HMC proposal and
the operations of a whole banded HMC query.

Peaks: NVIDIA's H100 SXM data sheet at 700 W, dense, without sparsity:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores.

The proposal's work is K2's (``dia_hmc_proposal``) at given shapes, frozen
here so that a later change of the program does not move the yardstick:
the latent rows in and out, the lane rows of the bands and their map, the
latent diagonal, h and inverse mass, the log acceptances, the step; and
``2 (K + 1)`` operations per embedded lane per chain per matrix-vector
product, ``n_leapfrog + 1`` products a trajectory.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

F32, I64 = 4, 8


def proposal_work(n_chains: int, n_latent: int, n_emb: int, n_offsets: int,
                  n_leapfrog: int) -> tuple:
    """(compulsory bytes, f32 operations) of one banded HMC proposal."""
    C, n, K = n_chains, n_latent, n_offsets
    n_bytes = (2 * C * n * F32            # x in, x1 out
               + K * n_emb * F32          # band weights
               + n_emb * I64              # lane -> latent map
               + 3 * n * F32              # diag, h, inverse mass
               + C * F32                  # log acceptances
               + F32)                     # step size
    flops = 2 * (K + 1) * C * n_emb * (n_leapfrog + 1)
    return n_bytes, flops


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the f32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def query_flops(n_chains: int, n_latent: int, n_emb: int, n_offsets: int,
                n_leapfrog: int, n_warmup: int, n_samples: int,
                stream_diag: bool) -> float:
    """The f32 operations that one ``run_hmc`` query on a banded Gaussian
    needs at the least: per transition and chain, the proposal's products
    (``proposal_work``), 2 per latent per momentum update (``n_leapfrog +
    1``) and 3 per position update (``n_leapfrog``), 10 per latent for the
    two kinetic and the two potential energies of the accept; per kept
    draw, 3 per latent for the moments and, with ``stream_diag``, 9 for the
    split-half Welford pairs, the lag-1 product and the batch sums. The
    warmup's adaptation and the program's selects are not counted."""
    C, n, L = n_chains, n_latent, n_leapfrog
    products = proposal_work(C, n, n_emb, n_offsets, L)[1]
    transition = products + C * n * (2 * (L + 1) + 3 * L + 10)
    draw = C * n * (3 + (9 if stream_diag else 0))
    return (n_warmup + n_samples) * transition + n_samples * draw
