"""The fused non-quadratic leapfrog's least time for the launches the
traced queries made (``roofline_hybrid.k5_least_s`` at the cell's shapes
times the queries' counted ``ops.k5.launches``: compulsory bytes over
the HBM rate or f32 operations over the peak, whichever is larger) over
the measured device busy time of the traced queries, in %. The
denominator is all device time of the traced queries, so the share reads
the same work whatever kernels carry it. Nothing where the program
counts no K5 launches."""

from portbench.roofline_hybrid import k5_least_s


def read(ctx):
    qs = ctx.queries
    if (ctx.trace is None or not ctx.trace["busy_s"] or not qs
            or "n_segments" not in ctx.cfg
            or any(q.get("k5_launches") is None for q in qs)):
        return None
    least = k5_least_s(ctx.mix["n_chains"], ctx.cfg,
                       ctx.mix["hmc"]["n_leapfrog"])
    return 100.0 * least * sum(q["k5_launches"] for q in qs) \
        / ctx.trace["busy_s"]
