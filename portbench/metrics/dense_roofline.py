"""The dense quadratic leapfrog's least time at the cell's shapes
(``roofline_dense.k1_least_s``: compulsory bytes over the HBM rate or
f32 operations over the peak, whichever is larger) times the traced
queries' transitions, one launch each, over the measured device busy
time of the traced queries, in %. The denominator is all device time of
the traced queries, so the share reads the same work whatever kernels
carry it. Nothing on a configuration without a dense form."""

from portbench.roofline_dense import k1_least_s


def read(ctx):
    qs = ctx.queries
    if (ctx.trace is None or not ctx.trace["busy_s"] or not qs
            or "n_latent" not in ctx.cfg or "dia_offsets" in ctx.cfg
            or "transitions" not in qs[0]):
        return None
    least = k1_least_s(ctx.mix["n_chains"], ctx.cfg["n_latent"],
                       ctx.mix["hmc"]["n_leapfrog"])
    return 100.0 * least * sum(q["transitions"] for q in qs) \
        / ctx.trace["busy_s"]
