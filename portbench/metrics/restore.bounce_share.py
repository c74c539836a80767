"""Share of each restore spent bouncing the tensors that are not 4-byte
words (the bf16 weights) through the host (``stage_s["bounce"]``)."""

from portbench.readers import restore_stage_share


def read(ctx):
    return restore_stage_share(ctx, "bounce")
