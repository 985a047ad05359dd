"""Device time launched under the program's ``hmc.transition`` span, per
transition the program counted (``hmc.transitions``) in the profiled
queries, in ms (``spans.split``). Nothing without the program's spans."""


def read(ctx):
    sp = getattr(ctx, "split", None)
    if not sp or not sp["busy_s"] or not sp["counts"].get("hmc.transitions"):
        return None
    return 1e3 * sp["device_s"].get("hmc.transition", 0.0) / sp["counts"][
        "hmc.transitions"]
