"""The fused NUTS trajectory's least time for the leaves the traced queries
integrated (``roofline_nuts.least_s``: compulsory bytes over the HBM rate
or f32 operations over the peak, whichever is larger) over the measured
device busy time of the whole traced window, in % (so the least time a
transition over the busy time a transition). The denominator is all
device time of the traced queries, so the share reads the same work
whatever kernels carry it. Nothing where the program counts no leaves."""

from portbench.roofline_nuts import least_s


def read(ctx):
    cfg, mix, qs = ctx.cfg, ctx.mix, ctx.queries
    if (ctx.trace is None or not ctx.trace["busy_s"] or not qs
            or any(q.get("leaves") is None for q in qs)):
        return None
    least = least_s(mix["n_chains"], cfg["n_latent"],
                    sum(q["transitions"] for q in qs),
                    sum(q["leaves"] for q in qs))
    return 100.0 * least / ctx.trace["busy_s"]
