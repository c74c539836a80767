"""Spans and counters of the port's read path, on the host clock.

``span(name, nbytes=0)`` is a context manager (``with`` in sync code and
worker threads, ``async with`` around awaits). It records nothing unless a
caller has installed a sink (:func:`install`); without one, and without a
``stages`` dict to fill, it is one shared object that reads no clock. A
recorded span reaches ``sink.add(name, t0, t1, nbytes, id, parent,
thread)`` as it ends:

- ``t0``, ``t1``: :data:`clock` (``time.perf_counter``), the clock a
  device trace is mapped to;
- ``id``: unique in the process; ``parent``: the id of the span open
  around it in the same task or thread, carried by a ``contextvars``
  variable, so it follows ``asyncio.to_thread`` and tasks (0: none);
- ``thread``: ``threading.get_ident()`` of the thread that ran it, or None
  for a span entered with ``async with``, which encloses awaits and holds
  no thread while it waits.

A span holds no tensor, array or exception. ``stages``: a dict of wall
seconds that the span adds its duration to, under the last dotted part of
its name (``restore.read`` adds to ``stages["read"]``); one clock read
serves both. :meth:`Span.phase` divides a span into consecutive child
spans that share their clock reads, so the phases sum to the span.

Counters (:func:`count`, :func:`counts`) are plain integers, always on.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time

#: The clock of every span.
clock = time.perf_counter

_sink = None
_parent: contextvars.ContextVar[int] = contextvars.ContextVar(
    "tpudfs_torch_trace_parent", default=0)
_ids = itertools.count(1)
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


def install(sink) -> None:
    """Record every span that begins from now on into ``sink``, whose
    ``add`` may be called from any thread."""
    global _sink
    _sink = sink


def uninstall() -> None:
    """Record no more spans."""
    global _sink
    _sink = None


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counts() -> dict[str, int]:
    """Every counter, as it stands."""
    with _counts_lock:
        return dict(_counts)


class _Off:
    """What :func:`span` returns when nothing records or times it."""

    __slots__ = ()
    nbytes = property(lambda self: 0, lambda self, n: None)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc) -> None:
        return None

    def phase(self, name: str) -> None:
        return None


OFF = _Off()


class Span:
    """One timed step; see the module's docstring. Set ``nbytes`` inside
    the block where the size is known only at its end."""

    __slots__ = ("name", "nbytes", "stages", "sink", "id", "parent", "t0",
                 "thread", "_token", "_phase", "_mark", "_phase_id")

    def __init__(self, name: str, nbytes: int, stages: dict | None, sink):
        self.name = name
        self.nbytes = nbytes
        self.stages = stages
        self.sink = sink
        self.id = self.parent = 0
        self._phase = None

    def _enter(self, awaits: bool) -> "Span":
        if self.sink is not None:
            self.id = next(_ids)
            self.parent = _parent.get()
            self._token = _parent.set(self.id)
        self.thread = None if awaits else threading.get_ident()
        self.t0 = self._mark = clock()
        return self

    def _exit(self) -> None:
        t1 = clock()
        if self._phase is not None:
            self._end(self._phase, self._mark, t1, 0, self._phase_id,
                      self.id, threading.get_ident())
        if self.sink is not None:
            _parent.reset(self._token)
        self._end(self.name, self.t0, t1, self.nbytes, self.id, self.parent,
                  self.thread)

    def _end(self, name, t0, t1, nbytes, id_, parent, thread) -> None:
        if self.stages is not None:
            key = name.rsplit(".", 1)[-1]
            self.stages[key] = self.stages.get(key, 0.0) + (t1 - t0)
        if self.sink is not None:
            self.sink.add(name, t0, t1, nbytes, id_, parent, thread)

    def phase(self, name: str) -> None:
        """End the current phase, if any, and begin phase ``name`` now; the
        first phase begins where the span began, and the span's end ends
        the last."""
        now = clock()
        if self._phase is not None:
            self._end(self._phase, self._mark, now, 0, self._phase_id,
                      self.id, threading.get_ident())
            self._mark = now
        self._phase = name
        self._phase_id = next(_ids) if self.sink is not None else 0

    def __enter__(self) -> "Span":
        return self._enter(False)

    def __exit__(self, *exc) -> None:
        self._exit()

    async def __aenter__(self) -> "Span":
        return self._enter(True)

    async def __aexit__(self, *exc) -> None:
        self._exit()


def span(name: str, nbytes: int = 0, stages: dict | None = None):
    """A span named ``name``: a :class:`Span`, or :data:`OFF` where no sink
    is installed and no ``stages`` is given."""
    sink = _sink
    if sink is None and stages is None:
        return OFF
    return Span(name, nbytes, stages, sink)
