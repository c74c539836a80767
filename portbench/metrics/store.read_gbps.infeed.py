"""L0 store and short circuit under the infeed: bytes the client's block
reads returned, over the time in which one was running."""

from portbench.readers import store_gbps


def read(ctx):
    return store_gbps(ctx, ("store.read_block",))
