"""Process start to the start of the window: the inputs, building and
compiling the model, loading the kernels, the warm-up query (host clock)."""


def read(ctx):
    return ctx.setup_s
