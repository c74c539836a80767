"""GF(2^8) rebuilds on the card per block restored (the port's
``gf256_matmul`` launch count over the window's blocks)."""


def read(ctx):
    blocks = ctx.work.get("blocks")
    if not blocks or ctx.device_kind == "cpu":
        return None
    return ctx.counters["launches"]["gf256_matmul"] / blocks
