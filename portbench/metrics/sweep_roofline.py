"""The chromatic Gibbs sweep's least time for the colour classes the
traced queries drew (``roofline_hybrid.sweep_class_least_s``, a class's
compulsory bytes over the HBM rate, times the queries' counted
``hmc.sweep_classes``) over the measured device busy time of the traced
queries, in %. The denominator is all device time of the traced queries,
so the share reads the same work whatever kernels carry it. Nothing
where the program counts no classes."""

from portbench.roofline_hybrid import sweep_class_least_s


def read(ctx):
    qs = ctx.queries
    if (ctx.trace is None or not ctx.trace["busy_s"] or not qs
            or "n_segments" not in ctx.cfg
            or any(q.get("sweep_classes") is None for q in qs)):
        return None
    least = sweep_class_least_s(ctx.mix["n_chains"], ctx.cfg)
    return 100.0 * least * sum(q["sweep_classes"] for q in qs) \
        / ctx.trace["busy_s"]
