"""In-process TCP fault-injection proxy: the port's copy of
``tpudfs/testing/netem.py``'s ``FaultProxy`` (partition, heal, sever and
latency; not its bandwidth shaping), which the fault tiers put in front
of a shard leader to partition it from a client.

A ``FaultProxy`` listens on a local port and pipes bytes to its upstream.
A client reaches the upstream through it by a host alias (the client's
``host_aliases={upstream: proxy.address}``), and the test flips toxics at
run time:

- ``partition`` refuses new connections and severs established ones;
- ``heal`` lets connections through again;
- ``sever`` resets the established connections once;
- ``set_latency`` delays each forwarded chunk.

The proxy runs on the event loop that starts it: a caller whose proxy
must outlive one ``asyncio.run`` keeps that loop running on a thread of
its own.
"""

from __future__ import annotations

import asyncio
import contextlib


class FaultProxy:
    """One listening port forwarding to one upstream address."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 listen_host: str = "127.0.0.1", listen_port: int = 0):
        self.upstream_host = upstream_host
        self.upstream_port = upstream_port
        self.listen_host = listen_host
        self.listen_port = listen_port
        self.partitioned = False
        self.latency = 0.0  # seconds added per forwarded chunk
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()

    @property
    def address(self) -> str:
        return f"{self.listen_host}:{self.listen_port}"

    async def start(self) -> str:
        self._server = await asyncio.start_server(
            self._handle, self.listen_host, self.listen_port
        )
        self.listen_port = self._server.sockets[0].getsockname()[1]
        return self.address

    async def stop(self) -> None:
        # Stop accepting first (close() does not block), so a retrying
        # client cannot open a fresh pipe after the sever; then kill the
        # live pipes; then bound the wait: wait_closed() blocks until every
        # handler ends, and a blackholed pipe never would.
        server, self._server = self._server, None
        if server is not None:
            server.close()
        self.sever()
        for t in list(self._conns):
            t.cancel()
        self._conns.clear()
        if server is not None:
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(server.wait_closed(), timeout=5.0)

    # ------------------------------------------------------------- toxics

    def partition(self) -> None:
        """Blackhole: refuse new connections and sever live ones."""
        self.partitioned = True
        self.sever()

    def heal(self) -> None:
        self.partitioned = False

    def set_latency(self, seconds: float) -> None:
        self.latency = seconds

    def sever(self) -> None:
        """Reset all established connections (a one-shot blip)."""
        for w in list(self._writers):
            with contextlib.suppress(Exception):
                w.transport.abort()
        self._writers.clear()

    # ------------------------------------------------------------ plumbing

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        if self.partitioned:
            writer.transport.abort()
            return
        try:
            up_reader, up_writer = await asyncio.open_connection(
                self.upstream_host, self.upstream_port
            )
        except OSError:
            writer.transport.abort()
            return
        self._writers.add(writer)
        self._writers.add(up_writer)

        async def pipe(src: asyncio.StreamReader,
                       dst: asyncio.StreamWriter) -> None:
            try:
                while True:
                    chunk = await src.read(64 * 1024)
                    if not chunk or self.partitioned:
                        break
                    if self.latency:
                        await asyncio.sleep(self.latency)
                    dst.write(chunk)
                    await dst.drain()
            except (ConnectionError, asyncio.CancelledError, OSError):
                pass
            finally:
                with contextlib.suppress(Exception):
                    dst.transport.abort()
                self._writers.discard(dst)

        t1 = asyncio.create_task(pipe(reader, up_writer))
        t2 = asyncio.create_task(pipe(up_reader, writer))
        self._conns.update({t1, t2})
        t1.add_done_callback(self._conns.discard)
        t2.add_done_callback(self._conns.discard)
