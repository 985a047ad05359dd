"""Host time inside the program's ``hmc.moments`` spans per draw step
(``hmc.draws``), in ms, from the queries run with the program's tracer on
and the profiler off. Nothing without the program's spans."""


def read(ctx):
    so = getattr(ctx, "spans_only", None)
    if not so or not so["counts"].get("hmc.draws"):
        return None
    return 1e3 * so["host_s"].get("hmc.moments", 0.0) / so["counts"][
        "hmc.draws"]
