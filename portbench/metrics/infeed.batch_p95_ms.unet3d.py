"""The batch wait's 95th percentile (as ``batch_p95_ms``) in a cell whose
window holds too few batches to hold it to a bound."""

from portbench.readers import step_p95_ms


def read(ctx):
    return step_p95_ms(ctx)
