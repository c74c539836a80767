"""The CRC32C verify kernels under the restore: each restored byte read
once at the card's HBM peak, over their device time."""

from portbench.readers import kernel_roofline

#: The kernels that verify a block on the card (``gpu/csrc/crc32c.cu``).
KERNELS = ("crc32c_kernel",)


def read(ctx):
    return kernel_roofline(ctx, KERNELS, "verified_bytes")
