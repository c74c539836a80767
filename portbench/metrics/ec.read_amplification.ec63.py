"""L1 EC read under the erasure-coded infeed: the shard bytes the
window's EC reads returned (the port's ``ec.shard_bytes``) over the
sample bytes it landed."""


def read(ctx):
    shard_bytes = ctx.counters.get("ec.shard_bytes", 0)
    landed = sum(s.nbytes for s in ctx.steps)
    return shard_bytes / landed if shard_bytes and landed else None
