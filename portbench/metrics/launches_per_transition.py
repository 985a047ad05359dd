"""Device kernels in the traced window over the sampler transitions in it
(queries x (n_warmup + n_samples))."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["busy_s"] or not ctx.queries or "transitions" not in ctx.queries[0]:
        return None
    return ctx.trace["n_kernels"] / sum(q["transitions"] for q in ctx.queries)
