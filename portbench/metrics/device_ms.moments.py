"""Device time launched under the program's ``hmc.moments`` span (the
moment and streamed-diagnostic update), per draw step the program counted
(``hmc.draws``) in the profiled queries, in ms (``spans.split``). Nothing
without the program's spans."""


def read(ctx):
    sp = getattr(ctx, "split", None)
    if not sp or not sp["busy_s"] or not sp["counts"].get("hmc.draws"):
        return None
    return 1e3 * sp["device_s"].get("hmc.moments", 0.0) / sp["counts"][
        "hmc.draws"]
