"""Adam steps of all completed fits over the window's wall time (host
clock, tracing off)."""


def read(ctx):
    if not ctx.queries or "steps" not in ctx.queries[0]:
        return None
    return sum(q["steps"] for q in ctx.queries) / ctx.window_s
