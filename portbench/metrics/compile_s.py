"""Host seconds of the compile call in set-up (``compile_graph`` or
``fast_compile``, to a finished device)."""


def read(ctx):
    return ctx.compile_s
