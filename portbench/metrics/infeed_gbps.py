"""Infeed rate: every sample byte landed verified on the device
in the window, over all of the window's time (closed loop)."""

from portbench.readers import window_gbps


def read(ctx):
    return window_gbps(ctx)
