"""L1 reader under the restore: the share of the window's host-to-device
bytes uploaded from pageable memory (the port's ``h2d.pageable_bytes``
over it and ``h2d.pinned_bytes``)."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    return program_trace.pageable_share(RECORDER.uploads, ctx.window)
