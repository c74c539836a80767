"""L1 reader under the restore: the share of ``reader.block`` time in which
the block had no child span open (its pread, upload, verify or EC step):
queued for a worker thread or for the event loop."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    return program_trace.wait_share(RECORDER.items, ctx.window)
