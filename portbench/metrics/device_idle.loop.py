"""The share of the profiled window in which the device idled while the
host was inside a transition or a moment update (the innermost program
span at the gap's midpoint ``hmc.transition`` or ``hmc.moments``), in %.
With ``device_idle.edges`` it sums to ``device_idle.sample``. Nothing
without the program's spans or with no device activity."""

from portbench.spans import loop_idle_pct


def read(ctx):
    sp = getattr(ctx, "split", None)
    if not sp or not sp["busy_s"] or not sp["n_spans"]:
        return None
    return loop_idle_pct(sp)
