"""L1 EC read under the erasure-coded infeed: the host's milliseconds per
EC block in the shards' stack, their upload and the decode's launch with
its pad (``ec.stack``, ``ec.upload``, ``ec.decode``), over every EC block
of the window, joined on the host or rebuilt on the device: the spans
grouped by the block that holds them."""

from portbench import program_trace

RECORDER = program_trace.recorder()


def read(ctx):
    if RECORDER is None:
        return None
    spans = program_trace.in_window(RECORDER.items, ctx.window,
                                    program_trace.EC_SPANS)
    blocks = {s[5] for s in spans}
    if not blocks:
        return None
    return sum(s[2] - s[1] for s in spans) / len(blocks) * 1e3
