"""Arithmetic that several metric readers share. Each reader
(``metrics/<name>.py``) takes what it needs from the run's context
(``portbench.harness.Context``) and returns a number, or None where the
run holds nothing to read (the harness then leaves the metric out)."""

from __future__ import annotations

import statistics

from portbench import roofline
from portbench.trace import covered


def window_gbps(ctx) -> float | None:
    """Every byte the window's steps landed, over all of its time."""
    nbytes = sum(s.nbytes for s in ctx.steps)
    return nbytes / ctx.window_s / 1e9 if nbytes and ctx.window_s else None


def p95_ms(seconds: list[float]) -> float | None:
    """The 95th percentile in ms (``statistics.quantiles``, inclusive);
    None below 20 samples, too few for that tail."""
    if len(seconds) < 20:
        return None
    return statistics.quantiles(seconds, n=100, method="inclusive")[94] * 1e3


def step_p95_ms(ctx) -> float | None:
    """The tail of the window's steps: the wait for each batch."""
    return p95_ms([s.t1 - s.t0 for s in ctx.steps])


def store_gbps(ctx, names: tuple[str, ...]) -> float | None:
    """Bytes the store calls named returned inside the window, over the
    time in which at least one of them was running."""
    spans = [s for name in names for s in ctx.in_window(name)]
    busy = covered([(s[1], s[2]) for s in spans])
    nbytes = sum(s[3] for s in spans)
    return nbytes / busy / 1e9 if busy and nbytes else None


def h2d_gbps(ctx) -> float | None:
    """Host-to-device copy bytes over the device time of those copies."""
    if ctx.device is None:
        return None
    copies = [(e - s, b) for n, c, s, e, b in ctx.device.ops
              if c == "gpu_memcpy" and "HtoD" in n and b]
    seconds = sum(t for t, _b in copies)
    return sum(b for _t, b in copies) / seconds / 1e9 if seconds else None


def kernel_roofline(ctx, kernels: tuple[str, ...], work: str) -> float | None:
    """The window's ``work`` bytes at the card's HBM peak over the device
    time of ``kernels``, in percent."""
    if ctx.device is None:
        return None
    return roofline.share(ctx.work.get(work, 0), ctx.device.seconds(kernels),
                          roofline.peak(ctx.device_kind, "hbm_bytes_per_s"))


def idle_share(ctx) -> float | None:
    """Percent of the traced window in which the card ran nothing."""
    if ctx.device is None or not ctx.device.window_s:
        return None
    return (1.0 - ctx.device.busy_s / ctx.device.window_s) * 100.0


def restore_stage_share(ctx, stage: str) -> float | None:
    """Percent of the window's restore time spent in ``stage``
    (``restore_shard_device``'s own ``stage_s``)."""
    total = sum(s.t1 - s.t0 for s in ctx.steps)
    if not ctx.stages or not total:
        return None
    return sum(st.get(stage, 0.0) for st in ctx.stages) / total * 100.0
