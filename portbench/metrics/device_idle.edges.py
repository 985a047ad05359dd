"""The rest of the profiled window's idle, in %: gaps under the query's own
span (init, warmup's phase change, finalize) or under no span (the copy to
the host, the next query's start), and the window's ends. With
``device_idle.loop`` it sums to ``device_idle.sample``. Nothing without the
program's spans or with no device activity."""

from portbench.spans import edges_idle_pct


def read(ctx):
    sp = getattr(ctx, "split", None)
    if not sp or not sp["busy_s"] or not sp["n_spans"]:
        return None
    return edges_idle_pct(sp)
