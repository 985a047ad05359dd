"""``correct`` for HMC posterior-moment queries on BASELINE config 2's
10 x 10 grid: the comparison of ``gauss_grid10.nuts_moments.py``, the
same exact answer and the same five gaps over all 82 latents, whichever
sampler produced the answers."""

from __future__ import annotations

from portbench.registry import Registry

judge = Registry().module("judges", "gauss_grid10.nuts_moments").judge
