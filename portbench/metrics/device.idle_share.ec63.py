"""Share of the traced window in which the card ran no kernel, copy or
memset, under the erasure-coded infeed."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
