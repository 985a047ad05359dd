"""Device kernels in the traced window over the Adam steps in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["busy_s"] or not ctx.queries or "steps" not in ctx.queries[0]:
        return None
    return ctx.trace["n_kernels"] / sum(q["steps"] for q in ctx.queries)
