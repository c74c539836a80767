"""Share of each restore spent reading its blocks into device memory,
verified (``restore_shard_device``'s ``stage_s["read"]``, host clock)."""

from portbench.readers import restore_stage_share


def read(ctx):
    return restore_stage_share(ctx, "read")
