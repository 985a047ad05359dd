"""The compulsory work of the robot-mapping HMLN's two hybrid layers at
given shapes, frozen here so that a later change of the program does not
move the yardstick: the fused non-quadratic leapfrog (K5,
``ops/logpot.py``) and one colour class of the chromatic Gibbs sweep.
Peaks and ``bound_s`` are ``roofline.py``'s (H100 SXM: 3.35 TB/s of HBM,
67 TFLOP/s f32). Both come from the configuration's structure (segments,
labelled types, missing depths), not from the program's plan.

**K5** (the arithmetic of ``chip_smoke.py``'s K5 bound, copied): a
launch over ``C`` chains and ``n`` latent depths reads each chain's
position and momentum and writes both back, reads the inverse mass, the
step and one discrete slot value of each non-quadratic factor row, and
writes the two energies: the bytes. The non-quadratic rows are the
``type_sets_depth`` factors, one a segment; the depth prior and the
smoothness are quadratic, folded into the ``n x n`` information form.
Each gradient evaluation (``n_steps + 1`` of them) runs each row with a
latent depth forward and in reverse (``3 * TAPE_NODES`` operations) and
the form's product (``2 n^2``); rows whose depth is observed run forward
once. ``TAPE_NODES`` is the length of the formula's tape as the port
traced it when this yardstick was frozen (16 nodes for ``-(d - (0.8 [t =
1] - 0.5 [t = 2]))^2``); at ``robot_map(100)``, C = 16,384, 8 steps the
bound is 0.0031 ms, bytes-bound, as PERF.md's table of kernels has it.

**A colour class of the sweep**: the chain of types is coloured by the
parity of the segment, so a class is the latent types of one parity. The
least a class's draw moves for ``C`` chains is every latent slot of the
class's adjacent rows other than the class's own (the neighbouring
types in the agreement rows, the segment's latent depth in its
``type_sets_depth`` row), 4 bytes each, read once a row, and the class's
new values, 4 bytes each, written. Observed slots are constants of the
configuration and are not counted per chain. The operations (a few per
row and candidate value) take under a tenth of the bytes' time and are
not counted.
"""

from __future__ import annotations

import numpy as np

from portbench.roofline import F32, bound_s

TAPE_NODES = 16


def k5_work(n_chains: int, n_segments: int, n_latent_depths: int,
            n_steps: int) -> tuple:
    """(compulsory bytes, f32 operations) of one K5 launch."""
    C, n, rows = n_chains, n_latent_depths, n_segments
    n_bytes = (4 * C * n          # x, p in; x1, p1 out
               + n + 1            # inverse mass, step
               + C * rows         # a discrete slot value a row
               + 2 * C) * F32     # the two energies
    per_eval = 3 * TAPE_NODES * n + 2 * n * n
    once = TAPE_NODES * (rows - n)
    return n_bytes, C * ((n_steps + 1) * per_eval + once)


def k5_least_s(n_chains: int, cfg: dict, n_steps: int) -> float:
    """K5's least time for one launch at the configuration's shapes."""
    return bound_s(*k5_work(n_chains, cfg["n_segments"],
                            cfg["n_latent_depths"], n_steps))


def latent_sets(cfg: dict):
    """(latent type segments, latent depth segments) from the
    configuration's structure: types labelled at ``n_type_labels``
    evenly spaced segments, depths missing where ``i % depth_miss_every
    == depth_miss_every - 1``."""
    n, miss = cfg["n_segments"], cfg["depth_miss_every"]
    labelled = set(np.linspace(0, n - 1, cfg["n_type_labels"]).astype(int)
                   .tolist())
    types = [i for i in range(n) if i not in labelled]
    depths = [i for i in range(n) if i % miss == miss - 1]
    return types, depths


def sweep_class_bytes(n_chains: int, cfg: dict) -> list:
    """The least bytes of each colour class's draw (even segments, then
    odd) for ``n_chains`` chains."""
    n = cfg["n_segments"]
    types, depths = latent_sets(cfg)
    lat_t, lat_d = set(types), set(depths)
    out = []
    for parity in (0, 1):
        cls = [i for i in types if i % 2 == parity]
        reads = sum((i in lat_d)
                    + sum(j in lat_t for j in (i - 1, i + 1) if 0 <= j < n)
                    for i in cls)
        out.append(n_chains * (reads + len(cls)) * F32)
    return out


def sweep_class_least_s(n_chains: int, cfg: dict) -> float:
    """The least time of one colour class's draw, the mean over the
    classes (a sweep draws each once)."""
    per = sweep_class_bytes(n_chains, cfg)
    return sum(bound_s(b, 0) for b in per) / len(per)
