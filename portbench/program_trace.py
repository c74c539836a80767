"""The port's own spans and counters in a traced run (``--trace 1``), and
the arithmetic of the per-layer metrics that read them.

The port records a span (``tpudfs_torch.common.trace``) only into a sink
that a caller installs. The harness loads the readers of a run's metrics
before its set-up, and loads the per-layer ones only in a traced run; a
reader of the port's spans calls :func:`recorder` when it is loaded, which
installs one :class:`Recorder` for the rest of the process. In a port
without the tracer it gives None, and those readers read nothing. A
recorded span is ``(name, t0, t1, nbytes, id, parent, thread)`` on the
host clock of :mod:`portbench.trace`, whose first four fields are the
harness's own span layout.

:func:`breakdown` puts the device trace's idle time down to the port's
spans, on a device trace mapped to the host clock from two points
(:func:`two_point`).
"""

from __future__ import annotations

from collections import defaultdict

from portbench.trace import DeviceTrace, _gaps, covered

#: What idle time is put down to where no span is open.
OUTSIDE = "outside every span"

_recorder = None


class Recorder:
    """The port's spans as they end (``items``), and its upload counters
    as each ``reader.h2d`` span ended: ``uploads``, (end, pageable bytes,
    pinned bytes), each a total since the process began."""

    def __init__(self, counts):
        self.items: list[tuple] = []
        self.uploads: list[tuple[float, int, int]] = []
        self._counts = counts

    def add(self, name, t0, t1, nbytes, id_, parent, thread) -> None:
        self.items.append((name, t0, t1, nbytes, id_, parent, thread))
        if name == "reader.h2d":
            c = self._counts()
            self.uploads.append((t1, c.get("h2d.pageable_bytes", 0),
                                 c.get("h2d.pinned_bytes", 0)))


def recorder() -> Recorder | None:
    """The process's recorder, installed as the port's sink; None where
    the port has no tracer."""
    global _recorder
    try:
        from tpudfs_torch.common import trace
    except ImportError:
        return None
    if _recorder is None:
        _recorder = Recorder(trace.counts)
    trace.install(_recorder)
    return _recorder


def in_window(spans: list, window: tuple[float, float],
              names: tuple[str, ...]) -> list:
    """Spans named ``names`` that began inside ``window``."""
    a, b = window
    return [s for s in spans if s[0] in names and a <= s[1] <= b]


def _children(spans: list) -> dict[int, list]:
    out = defaultdict(list)
    for s in spans:
        out[s[5]].append(s)
    return out


def _self_intervals(span: tuple, children: list) -> list:
    """The parts of ``span`` that none of ``children`` covers."""
    return _gaps([(c[1], c[2]) for c in children], span[1], span[2])


def pread_gbps(spans: list, window) -> float | None:
    """``store.pread`` bytes over the union of those spans' self time, the
    chunk grid's allocation (``reader.grid``) left out, in GB/s."""
    preads = in_window(spans, window, ("store.pread",))
    kids = _children(in_window(spans, window, ("reader.grid",)))
    busy = covered([iv for s in preads
                    for iv in _self_intervals(s, kids[s[4]])])
    nbytes = sum(s[3] for s in preads)
    return nbytes / busy / 1e9 if busy and nbytes else None


def wait_share(spans: list, window) -> float | None:
    """Percent of ``reader.block`` time in which the block has no child
    span open: queued for a worker thread or for the event loop."""
    blocks = in_window(spans, window, ("reader.block",))
    if not blocks:
        return None
    kids = _children(spans)
    total = sum(s[2] - s[1] for s in blocks)
    idle = sum(covered(_self_intervals(s, kids[s[4]])) for s in blocks)
    return idle / total * 100.0 if total else None


def pageable_share(uploads: list, window) -> float | None:
    """Percent of the window's host-to-device bytes that came from pageable
    memory: the counters' change from the last upload before the window to
    the last inside it."""
    a, b = window
    before = [u for u in uploads if u[0] < a]
    inside = [u for u in uploads if a <= u[0] <= b]
    if not before or not inside:
        return None
    _t, p0, q0 = max(before)
    _t, p1, q1 = max(inside)
    total = (p1 - p0) + (q1 - q0)
    return (p1 - p0) / total * 100.0 if total else None


def inflight(spans: list, window) -> float | None:
    """The time-average count of open ``reader.block`` spans over the
    window."""
    a, b = window
    open_s = sum(min(s[2], b) - max(s[1], a) for s in spans
                 if s[0] == "reader.block" and s[1] < b and s[2] > a)
    return open_s / (b - a) if b > a and open_s else None


#: The EC degraded read's host side, one block at a time.
EC_SPANS = ("ec.stack", "ec.upload", "ec.decode")


def ec_host_ms_per_block(spans: list, window) -> float | None:
    """Milliseconds of ``ec.stack``, ``ec.upload`` and ``ec.decode`` per
    block rebuilt in the window (a block whose spans include a decode)."""
    by_block = _children(in_window(spans, window, EC_SPANS))
    rebuilt = [ss for ss in by_block.values()
               if any(s[0] == "ec.decode" for s in ss)]
    if not rebuilt:
        return None
    return sum(s[2] - s[1] for ss in rebuilt for s in ss) / len(rebuilt) * 1e3


def two_point(device: DeviceTrace, end: float) -> tuple[DeviceTrace, float]:
    """``device`` (mapped from one point: the window range's start, at the
    host clock read just inside it) mapped again from two: the range's end
    is ``end``, a host clock read just inside it too. Returns the new
    trace and the two points' disagreement in microseconds: where the
    one-point map put the range's end, less ``end``."""
    a, b = device.window

    def host(t: float) -> float:
        return a + (t - a) * (end - a) / (b - a)

    ops = [(n, c, host(s), host(e), nb) for n, c, s, e, nb in device.ops]
    return DeviceTrace(ops, (a, end)), (b - end) * 1e6


def breakdown(device: DeviceTrace, program: list, harness: list,
              top: int = 10) -> dict:
    """The device operations that took most time, and the idle time summed
    by what the host was doing. Each idle gap is cut where a span begins
    or ends, and each piece is put down:

    - in equal shares to the threads running a program span that holds
      its thread (``thread`` not None), each thread's innermost one;
    - else to the innermost open program span that encloses awaits;
    - else to the innermost open harness span;
    - else to :data:`OUTSIDE`.

    Every open span counts, found by one sweep over the gaps in order.
    (Naming a whole gap after its middle put a gap of host copy, CRC and
    copy under the CRC alone.)"""
    gaps = _gaps([(s, e) for _n, _c, s, e, _b in device.ops], *device.window)
    events = sorted(
        [(s[1], 0, i, s) for i, s in enumerate(program)]
        + [(s[2], 1, i, s) for i, s in enumerate(program)]
        + [(s[1], 0, -1 - i, s) for i, s in enumerate(harness)]
        + [(s[2], 1, -1 - i, s) for i, s in enumerate(harness)],
        key=lambda ev: (ev[0], ev[1]))
    open_: dict[int, tuple] = {}
    idle: dict[str, float] = defaultdict(float)
    k = 0
    for s, e in gaps:
        t = s
        while t < e:
            while k < len(events) and events[k][0] <= t:
                _t, end, key, span = events[k]
                if end:
                    open_.pop(key, None)
                else:
                    open_[key] = span
                k += 1
            nxt = min(events[k][0], e) if k < len(events) else e
            _put_down(open_, nxt - t, idle)
            t = nxt
    return {"device_ops": device.breakdown([], top)["device_ops"],
            "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                                key=lambda nv: -nv[1])[:top]}


def _put_down(open_: dict, seconds: float, idle: dict) -> None:
    """Add ``seconds`` of idle time to what the open spans say the host
    was doing (:func:`breakdown`'s rule)."""
    threads: dict[int, tuple] = {}
    awaiting = outer = None
    for key, sp in open_.items():
        if key < 0:
            if outer is None or sp[1] > outer[1]:
                outer = sp
        elif sp[6] is None:
            if awaiting is None or sp[1] > awaiting[1]:
                awaiting = sp
        elif sp[6] not in threads or sp[1] > threads[sp[6]][1]:
            threads[sp[6]] = sp
    if threads:
        for sp in threads.values():
            idle[sp[0]] += seconds / len(threads)
    else:
        idle[(awaiting or outer or (OUTSIDE,))[0]] += seconds
