"""Kept chain-samples (chains x n_samples) of all completed queries over the
window's wall time (host clock, tracing off)."""


def read(ctx):
    if not ctx.queries or "samples" not in ctx.queries[0]:
        return None
    return sum(q["samples"] for q in ctx.queries) / ctx.window_s
