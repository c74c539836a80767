"""Set-up time: from the start of the process to the start of the
measured window (imports, CUDA start, data made and stored, kernels built
and loaded, the warm-up)."""


def read(ctx):
    return ctx.setup_s
