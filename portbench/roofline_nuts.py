"""The compulsory work of the fused NUTS trajectory (K3,
``ops/nuts_traj.py``) and the operations of a whole dense NUTS query, at
given shapes and leaf counts, frozen here so that a later change of the
program does not move the yardstick. Peaks and ``bound_s`` are
``roofline.py``'s (H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s f32).

A transition of ``C`` chains over ``n`` latents on a dense information
form (J, h) reads each chain's position and momentum and writes its
proposal, and reads J, h and the inverse mass once: the bytes. Its
operations are the trees' leaves: a leaf is one product ``q J`` (2n^2)
and 14n more (the two half-step momentum updates, the position update,
the gradient ``h - q J``, the log density and the kinetic energy); each
chain's trajectory starts with one product at its initial position (2n^2
+ 7n: gradient, log density, kinetic energy). The U-turn checks, the
multinomial choices and the merges are not counted.
"""

from __future__ import annotations

from portbench.roofline import F32, bound_s


def leaf_flops(n: int) -> int:
    return 2 * n * n + 14 * n


def start_flops(n: int) -> int:
    return 2 * n * n + 7 * n


def transition_bytes(n_chains: int, n_latent: int) -> int:
    """Compulsory bytes of one transition: q and p in, q out, J, h and the
    inverse mass."""
    C, n = n_chains, n_latent
    return (3 * C * n + n * n + 2 * n) * F32


def trajectory_flops(n_chains: int, n_latent: int, leaves: int) -> int:
    """f32 operations of the trajectories of one or more transitions: each
    chain's start, once a transition (``n_chains`` counts chains times
    transitions), and ``leaves`` leaves."""
    return n_chains * start_flops(n_latent) + leaves * leaf_flops(n_latent)


def least_s(n_chains: int, n_latent: int, n_transitions: int,
            leaves: int) -> float:
    """The least time the card could take for ``n_transitions`` transitions
    of ``n_chains`` chains that integrated ``leaves`` leaves in all: the
    larger of the bytes over the HBM rate and the operations over the f32
    rate (summed over the transitions before the larger is taken, so never
    above the sum of each transition's own bound)."""
    return bound_s(n_transitions * transition_bytes(n_chains, n_latent),
                   trajectory_flops(n_transitions * n_chains, n_latent,
                                    leaves))


def query_flops(n_chains: int, n_latent: int, n_warmup: int, n_samples: int,
                leaves: int, stream_diag: bool) -> int:
    """The f32 operations one dense ``run_nuts`` query needs at the least:
    the trajectories (``trajectory_flops`` over every transition), one
    scaling of the drawn momenta per latent and chain a transition, the
    warmup's Welford batch (4 per latent and chain a warmup transition);
    per kept draw, 3 per latent and chain for the moments and, with
    ``stream_diag``, 9 for the split-half Welford pairs, the lag-1 product
    and the batch sums. Dual averaging's scalars are not counted."""
    C, n = n_chains, n_latent
    T = n_warmup + n_samples
    return (trajectory_flops(T * C, n, leaves) + T * C * n
            + n_warmup * 4 * C * n
            + n_samples * C * n * (3 + (9 if stream_diag else 0)))
