"""Share of the traced window in which no device activity ran:
1 - (union of the device activities' intervals) / window, in % (sampler queries)."""

from portbench.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
