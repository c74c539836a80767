"""L0 store under ``DfsInfeed``: the bytes of the port's own preads
(``store.pread``, inside the worker thread) over the union of those
spans' own time, the chunk grid's zero-fill (``reader.grid``) left out."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    return program_trace.pread_gbps(RECORDER.items, ctx.window)
