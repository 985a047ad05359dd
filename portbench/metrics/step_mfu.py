"""The whole query's share of the card's peak f32 rate, in %: the
operations a banded ``run_hmc`` query needs (``roofline.query_flops``:
every transition's proposal, leapfrog updates and energies, every kept
draw's moment and diagnostic updates) over the host-clock seconds of the
traced run's untraced queries, at 67 TFLOP/s. Nothing on a configuration
without bands."""

from portbench.roofline import F32_FLOPS_PER_S, query_flops


def read(ctx):
    cfg, mix, plain = ctx.cfg, ctx.mix, ctx.untraced
    if plain is None or "dia_offsets" not in cfg or not plain["queries"]:
        return None
    flops = len(plain["queries"]) * query_flops(
        mix["n_chains"], cfg["n_latent"], cfg["n_emb"],
        len(cfg["dia_offsets"]), mix["hmc"]["n_leapfrog"], mix["n_warmup"],
        mix["n_samples"], mix["stream_diag"])
    return 100.0 * flops / (plain["seconds"] * F32_FLOPS_PER_S)
