"""The 90th percentile of the wall time of every query of the window
(host clock, tracing off; linear interpolation between order statistics).
Nothing below ten queries, where it would be a maximum."""

import numpy as np


def read(ctx):
    walls = [q["wall_s"] for q in ctx.queries]
    if len(walls) < 10:
        return None
    return float(np.percentile(walls, 90))
