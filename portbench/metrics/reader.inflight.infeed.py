"""L1 reader under ``DfsInfeed``: the time-average count of blocks in
flight (open ``reader.block`` spans) over the window."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    return program_trace.inflight(RECORDER.items, ctx.window)
