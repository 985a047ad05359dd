"""The banded HMC proposal's least time at the cell's shapes (its
compulsory bytes over the HBM rate or its f32 operations over the peak,
whichever is larger; ``roofline.proposal_work``) over the measured device
busy time of a whole transition, in %. The denominator is all device time
of the traced transitions, so the share reads the same work whatever
kernels carry it. Nothing on a configuration without bands."""

from portbench.roofline import bound_s, proposal_work


def read(ctx):
    cfg, mix = ctx.cfg, ctx.mix
    if (ctx.trace is None or not ctx.trace["busy_s"] or "dia_offsets" not in cfg
            or not ctx.queries or "transitions" not in ctx.queries[0]):
        return None
    n_trans = sum(q["transitions"] for q in ctx.queries)
    least = bound_s(*proposal_work(
        mix["n_chains"], cfg["n_latent"], cfg["n_emb"],
        len(cfg["dia_offsets"]), mix["hmc"]["n_leapfrog"]))
    return 100.0 * least / (ctx.trace["busy_s"] / n_trans)
