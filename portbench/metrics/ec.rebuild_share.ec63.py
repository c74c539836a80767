"""L1 EC read under the erasure-coded infeed: the share of the window's EC
blocks that were rebuilt on the device (the port's ``ec.blocks_rebuilt``
over it and ``ec.blocks_assembled``, the blocks joined from their data
shards)."""


def read(ctx):
    rebuilt = ctx.counters.get("ec.blocks_rebuilt", 0)
    landed = rebuilt + ctx.counters.get("ec.blocks_assembled", 0)
    return rebuilt / landed * 100.0 if landed else None
