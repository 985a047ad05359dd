"""A whole dense NUTS query's share of the card's peak f32 rate, in %: the
operations of the untraced queries of the traced run
(``roofline_nuts.query_flops`` with each query's counted leaves: the
trajectories' products and updates, the momenta, the adaptation, every
kept draw's moment and diagnostic updates) over their host-clock seconds,
at 67 TFLOP/s. Nothing where the program counts no leaves."""

from portbench.roofline import F32_FLOPS_PER_S
from portbench.roofline_nuts import query_flops


def read(ctx):
    cfg, mix, plain = ctx.cfg, ctx.mix, ctx.untraced
    if (plain is None or not plain["queries"]
            or any(q.get("leaves") is None for q in plain["queries"])):
        return None
    flops = sum(query_flops(mix["n_chains"], cfg["n_latent"],
                            mix["n_warmup"], mix["n_samples"], q["leaves"],
                            mix["stream_diag"]) for q in plain["queries"])
    return 100.0 * flops / (plain["seconds"] * F32_FLOPS_PER_S)
