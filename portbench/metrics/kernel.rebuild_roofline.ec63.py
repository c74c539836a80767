"""The GF(2^8) rebuild kernel under the erasure-coded infeed: the surviving
shard bytes read and the lost data shard written for each landed block
whose lost shard is a data shard (``portbench.roofline.rebuild_bytes``)
at the card's HBM peak, over its device time."""

from portbench.readers import kernel_roofline

#: The kernel that rebuilds a degraded block (``gpu/csrc/gf256.cu``).
KERNELS = ("gf256_nibble_kernel",)


def read(ctx):
    return kernel_roofline(ctx, KERNELS, "rebuild_bytes")
