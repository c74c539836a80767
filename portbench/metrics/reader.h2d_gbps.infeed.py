"""L1 reader's per-block path under ``DfsInfeed``: host-to-device copy
bytes over the device time of those copies (device trace)."""

from portbench.readers import h2d_gbps


def read(ctx):
    return h2d_gbps(ctx)
