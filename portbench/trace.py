"""Spans and the device trace of a traced run (``--trace 1``).

Spans come from the benchmark's own files, around calls into the port's
layers: :class:`TracedClient` wraps the DFS client that the harness hands
to the entry (the L0 store reads). A span is ``(name, start, end, bytes)``
on the host's monotonic clock. Spans are kept in memory.

:func:`device_profile` runs the measured window under ``torch.profiler``
and reduces its trace to :class:`DeviceTrace`: the kernels, copies and
memsets that ran on the card inside the window, on the same clock as the
spans.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

clock = time.perf_counter

#: The profiler range that marks the measured window in the trace.
WINDOW = "portbench.window"
#: Trace categories of work that ran on the card.
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
#: Spans looked at, latest start first, to name what the host did in an
#: idle gap: more than one step's spans (a restore makes 27).
SPAN_LOOKBACK = 64


class Spans:
    """Spans kept in memory."""

    def __init__(self):
        self.items: list[tuple[str, float, float, int]] = []

    def add(self, name: str, t0: float, t1: float, nbytes: int = 0) -> None:
        self.items.append((name, t0, t1, nbytes))


class TracedClient:
    """A DFS client whose block reads and shard reads are spans
    (``store.read_block``, ``store.read_ec_shards``: the bytes returned, 0
    for a call that raised); every other attribute is the wrapped
    client's."""

    def __init__(self, client, spans: Spans):
        self._client = client
        self._spans = spans

    def __getattr__(self, name):
        return getattr(self._client, name)

    async def _timed(self, name: str, call, size) -> object:
        t0, out = clock(), None
        try:
            out = await call
            return out
        finally:
            self._spans.add(name, t0, clock(), size(out) if out is not None else 0)

    async def _read_block_range(self, block, offset, length, **kw):
        return await self._timed(
            "store.read_block",
            self._client._read_block_range(block, offset, length, **kw), len)

    async def _read_ec_shards(self, block, **kw):
        return await self._timed(
            "store.read_ec_shards", self._client._read_ec_shards(block, **kw),
            lambda shards: sum(len(s) for s in shards if s is not None))


def covered(intervals: list[tuple[float, float]]) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        s = max(s, end)
        if e > s:
            total += e - s
            end = e
    return total


def _gaps(intervals, a: float, b: float) -> list[tuple[float, float]]:
    """The parts of [a, b] that no interval covers."""
    out, end = [], a
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, b)))
        end = max(end, e)
    if end < b:
        out.append((end, b))
    return [(s, e) for s, e in out if e > s]


def kernel_name(name: str) -> str:
    """A kernel's function name, without its return type, namespaces,
    template arguments and arguments: ``void (anonymous
    namespace)::crc32c_kernel(Args)`` is ``crc32c_kernel``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].split("<")[0].strip().rsplit("::", 1)[-1]


class DeviceTrace:
    """What ran on the card inside the window: ``ops`` as (name, category,
    start, end, bytes) on the host clock, clipped to the window."""

    def __init__(self, ops: list, window: tuple[float, float]):
        self.ops = ops
        self.window = window

    @classmethod
    def from_events(cls, events: list, anchor: float) -> "DeviceTrace":
        """From a Chrome trace's events (``ts``, ``dur`` in microseconds);
        ``anchor`` is the host clock when the window's range began."""
        win = next(e for e in events
                   if e.get("name") == WINDOW and e.get("ph") == "X")
        a_us = float(win["ts"])
        b_us = a_us + float(win["dur"])

        def host(us: float) -> float:
            return anchor + (us - a_us) / 1e6

        ops = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_WORK:
                continue
            s = max(float(e["ts"]), a_us)
            t = min(float(e["ts"]) + float(e["dur"]), b_us)
            if t > s:
                nbytes = (e.get("args") or {}).get("bytes")
                ops.append((e.get("name", ""), e["cat"], host(s), host(t),
                            nbytes))
        return cls(ops, (anchor, host(b_us)))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return covered([(s, e) for _n, _c, s, e, _b in self.ops])

    def seconds(self, kernels: tuple[str, ...]) -> float:
        """Device seconds of the kernels named (by function name)."""
        return sum(e - s for n, c, s, e, _b in self.ops
                   if c == "kernel" and kernel_name(n) in kernels)

    def breakdown(self, spans: list, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        between them summed by what the host was doing: the innermost
        harness span (latest start) around each gap's middle."""
        by_op = defaultdict(float)
        for n, c, s, e, _b in self.ops:
            by_op[kernel_name(n) if c == "kernel" else n] += e - s
        idle = defaultdict(float)
        ordered = sorted(spans, key=lambda sp: sp[1])
        starts = [sp[1] for sp in ordered]
        for s, e in _gaps([(s, e) for _n, _c, s, e, _b in self.ops],
                          *self.window):
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            name = "outside every span"
            for j in range(i - 1, max(i - 1 - SPAN_LOOKBACK, -1), -1):
                if ordered[j][2] >= mid:
                    name = ordered[j][0]
                    break
            idle[name] += e - s
        return {key: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
                for key, d in (("device_ops", by_op), ("idle_gaps", idle))}


@contextlib.contextmanager
def device_profile(work_dir: Path, cuda: bool):
    """Profile the body as the measured window; afterwards ``box["trace"]``
    is its :class:`DeviceTrace`. The Chrome trace is written under
    ``work_dir`` only while it is read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    box: dict = {}
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            box["anchor"] = clock()
            yield box
    path = Path(work_dir) / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    box["trace"] = DeviceTrace.from_events(events, box["anchor"])
