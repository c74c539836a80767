"""L1 EC degraded read under the cold restore: the host's milliseconds per
rebuilt block in the shards' stack, their upload and the decode's launch
with its pad (``ec.stack``, ``ec.upload``, ``ec.decode``)."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    return program_trace.ec_host_ms_per_block(RECORDER.items, ctx.window)
