"""Checkpoint restore rate: every shard byte restored bit-exact into
device memory in the window, over all of the window's time (closed loop;
each restore from the call to its last tensor, ended by a synchronize)."""

from portbench.readers import window_gbps


def read(ctx):
    return window_gbps(ctx)
