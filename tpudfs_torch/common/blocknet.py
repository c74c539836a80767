"""Raw-TCP bulk data plane ("blockport") — the client half of
``tpudfs/common/blocknet.py``, the port's own copy.

Block payloads skip gRPC: each chunkserver advertises a second listener
(the ``DataPort`` gRPC method) that speaks length-prefixed frames, both
directions::

    u32 header_len | msgpack(header) | u64 payload_len | payload bytes

Request header ``{"m": <method>, **fields}``; the payload carries what the
gRPC twin would put in ``req["data"]``. Response header ``{"ok": True,
**fields}`` (payload = ``resp["data"]``) or ``{"ok": False, "code":
<grpc StatusCode name>, "message": str}``, which re-raises as
:class:`~tpudfs_torch.common.rpc.RpcError`, so callers' retry logic does
not depend on the transport. The deadline budget rides the header as
``_db`` (relative seconds) and the tenant as ``_tn``.

Discovery: :class:`BlockConnPool` resolves a peer's blockport once through
``DataPort`` and caches it; a peer that answers UNIMPLEMENTED stays on
gRPC for good, and a transport failure opens the address's breaker, so
calls to it go over gRPC until a half-open probe heals it. Aliased
addresses (``Client.host_aliases``) never take the blockport: the client
keeps them on gRPC, so an interposer on the gRPC address cannot be
bypassed by the data side channel. The server half (``BlockPortServer``)
is not here.
"""

from __future__ import annotations

import asyncio
import logging
import os
import socket
import ssl
import struct

import grpc
import msgpack

from tpudfs_torch.common.resilience import (
    OVERLOADED_PREFIX,
    TENANT_FRAME_KEY,
    BreakerBoard,
    BudgetExhausted,
    attempt_timeout,
    overloaded_message,
    raw_tenant,
    remaining_budget,
)
from tpudfs_torch.common.rpc import ClientTls, RpcClient, RpcError

logger = logging.getLogger(__name__)


def _read_cap(name: str) -> int:
    try:
        with open(f"/proc/sys/net/core/{name}") as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return 0


#: Explicit socket buffers disable kernel autotuning and clamp to
#: net.core.{w,r}mem_max: pin big buffers only where the caps allow >= 1 MiB.
_SOCK_BUF = min(4 << 20, _read_cap("wmem_max"), _read_cap("rmem_max"))
if _SOCK_BUF < (1 << 20):
    _SOCK_BUF = 0


def _tune_socket(sock) -> None:
    if not _SOCK_BUF:
        return
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, _SOCK_BUF)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _SOCK_BUF)
    except OSError:
        pass


_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_MAX_HEADER = 1 << 20
_MAX_PAYLOAD = 100 * 1024 * 1024  # the gRPC plane's message cap
#: asyncio stream buffer limit: a multi-MiB frame with the 64 KiB default
#: wakes the protocol once per 64 KiB.
_STREAM_LIMIT = 4 * 1024 * 1024
#: Scatter-read chunk: big enough to amortize event-loop trips, small
#: enough to stay within the stream buffer's high-water mark.
_READ_INTO_CHUNK = 1 << 20
#: Only drain once the transport's write buffer backs up past this.
_DRAIN_WATERMARK = 1 << 18


def enabled() -> bool:
    """The reference's switch: ``TPUDFS_BLOCKPORT=0`` keeps every payload
    on gRPC."""
    return os.environ.get("TPUDFS_BLOCKPORT", "1") != "0"


def _pack_frame(header: dict, payload) -> list:
    """``payload=None`` means "no data field"; ``b""`` is a real, empty
    data field — the ``_d`` header flag keeps the two apart. ``payload``
    may be a list of buffers, which go to ``writelines`` unjoined."""
    if payload is not None:
        header["_d"] = 1
    h = msgpack.packb(header, use_bin_type=True)
    if isinstance(payload, (list, tuple)):
        plen = sum(len(p) for p in payload)
        out = [_U32.pack(len(h)), h, _U64.pack(plen)]
        out.extend(p for p in payload if len(p))
        return out
    out = [_U32.pack(len(h)), h, _U64.pack(len(payload) if payload else 0)]
    if payload:
        out.append(payload)
    return out


async def _read_frame(r: asyncio.StreamReader, into=None
                      ) -> tuple[dict, bytes | None]:
    """One frame. ``into``: optional scatter callback ``(header, plen) ->
    segments`` (writable buffers summing to plen); the payload then streams
    straight into them and ``(header, None)`` returns. A None result from
    the callback falls back to the bytes path."""
    hlen = _U32.unpack(await r.readexactly(4))[0]
    if hlen > _MAX_HEADER:
        raise ConnectionError(f"blockport header too large: {hlen}")
    header = msgpack.unpackb(await r.readexactly(hlen), raw=False,
                             strict_map_key=False)
    plen = _U64.unpack(await r.readexactly(8))[0]
    if plen > _MAX_PAYLOAD:
        raise ConnectionError(f"blockport payload too large: {plen}")
    if plen and into is not None:
        segments = into(header, plen)
        if segments is not None:
            await _read_into(r, segments, plen)
            return header, None
    payload = await r.readexactly(plen) if plen else b""
    return header, payload


async def _read_into(r: asyncio.StreamReader, segments, plen: int) -> None:
    views = [memoryview(seg).cast("B") for seg in segments]
    total = sum(len(v) for v in views)
    if total != plen:
        # The connection is mid-payload and cannot be resynced.
        raise ConnectionError(
            f"scatter segments cover {total} of {plen} payload bytes")
    for v in views:
        off, n = 0, len(v)
        while off < n:
            chunk = await r.read(min(_READ_INTO_CHUNK, n - off))
            if not chunk:
                raise asyncio.IncompleteReadError(b"", plen)
            v[off : off + len(chunk)] = chunk
            off += len(chunk)


async def _drain_backpressure(w: asyncio.StreamWriter) -> None:
    transport = w.transport
    if transport is None or \
            transport.get_write_buffer_size() > _DRAIN_WATERMARK:
        await w.drain()


def _error_from_header(header: dict) -> RpcError:
    """The RpcError an ``{"ok": False}`` frame stands for. Native sheds
    carry a structured ``retry_after``: it is folded into the
    ``Overloaded|`` envelope the retry budget reads."""
    code = getattr(grpc.StatusCode, str(header.get("code")),
                   grpc.StatusCode.INTERNAL)
    message = str(header.get("message") or "")
    hinted = header.get("retry_after")
    if (isinstance(hinted, (int, float))
            and code is grpc.StatusCode.RESOURCE_EXHAUSTED
            and not message.startswith(OVERLOADED_PREFIX)):
        message = overloaded_message(float(hinted), message)
    return RpcError(code, message)


class BlockConnPool:
    """Per-address pooled blockport client with gRPC-probed discovery and
    transparent gRPC fallback: ``call(rpc, addr, service, method, req)``
    sends over the peer's blockport when one is advertised and over ``rpc``
    otherwise."""

    #: idle connections kept per peer; extras close on release.
    MAX_IDLE_PER_PEER = 8

    def __init__(self, tls: ClientTls | None = None):
        self._tls = tls
        self._free: dict[str, list] = {}
        #: addr -> port, or None: the peer has no blockport (final, from an
        #: UNIMPLEMENTED probe).
        self._ports: dict[str, int | None] = {}
        #: addr -> whether the blockport is the native engine, which
        #: forwards chains only to blockports (see chain_info()).
        self._native: dict[str, bool] = {}
        #: addr -> whether the peer speaks the WriteStream frame protocol
        #: (fail closed: a peer without the probe field gets False).
        self._stream: dict[str, bool] = {}
        #: One failure opens for 5 s, consecutive opens double the window
        #: up to 30 s, one half-open probe per window re-tests the peer.
        self.breakers = BreakerBoard(failure_threshold=1, reset_timeout=5.0,
                                     max_reset=30.0)
        #: in-flight DataPort probes, shared by concurrent first callers.
        self._probes: dict[str, asyncio.Task] = {}
        self._ssl_ctx: ssl.SSLContext | None = None
        if tls is not None:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.load_verify_locations(tls.ca_path)
            if tls.cert_path and tls.key_path:
                ctx.load_cert_chain(tls.cert_path, tls.key_path)
            self._ssl_ctx = ctx

    async def _data_port(self, rpc: RpcClient, addr: str,
                         service: str) -> int | None:
        if addr in self._ports:
            return self._ports[addr]
        if not self.breakers.allow(addr):
            return None  # breaker open: stay on gRPC until a probe heals it
        probe = self._probes.get(addr)
        if probe is None:
            probe = asyncio.create_task(self._probe(rpc, addr, service))
            self._probes[addr] = probe
            probe.add_done_callback(
                lambda _t, a=addr: self._probes.pop(a, None))
        try:
            return await asyncio.shield(probe)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.debug("blocknet probe of %s failed", addr, exc_info=True)
            return None

    async def _probe(self, rpc: RpcClient, addr: str,
                     service: str) -> int | None:
        try:
            resp = await rpc.call(addr, service, "DataPort", {}, timeout=5.0)
            port = int(resp.get("port") or 0) or None
        except RpcError as e:
            if e.code == grpc.StatusCode.UNIMPLEMENTED:
                self._ports[addr] = None  # pre-blockport peer: final
                self.breakers.record_success(addr)
            else:
                self.breakers.record_failure(addr)
            return None
        self.breakers.record_success(addr)
        self._ports[addr] = port
        # Fail closed: a blockport without the `native` field is treated
        # as the native engine.
        self._native[addr] = bool(resp.get("native", port is not None))
        self._stream[addr] = bool(resp.get("stream", False))
        return port

    async def data_ports(self, rpc: RpcClient, addrs: list[str],
                         service: str) -> list[int]:
        """Every address's blockport, resolved concurrently; 0 = none."""
        if not enabled() or not addrs:
            return [0] * len(addrs)
        ports = await asyncio.gather(
            *(self._data_port(rpc, a, service) for a in addrs))
        return [int(p or 0) for p in ports]

    async def chain_info(self, rpc: RpcClient, addrs: list[str],
                         service: str) -> tuple[list[int], bool]:
        """(ports, first_hop_safe): whether sending the chain through the
        first hop's blockport keeps full replication. The native engine
        forwards only to blockports, so it needs every hop resolvable."""
        ports = await self.data_ports(rpc, addrs, service)
        if not ports or not ports[0]:
            return ports, False
        if all(ports):
            return ports, True
        return ports, not self._native.get(addrs[0], False)

    def stream_chain_ok(self, addrs: list[str]) -> bool:
        """True when every chain member's blockport speaks WriteStream."""
        return bool(addrs) and all(self._stream.get(a, False) for a in addrs)

    async def write_stream(self, rpc: RpcClient, addr: str, service: str,
                           req: dict, data,
                           timeout: float = 60.0) -> dict | None:
        """One block as a pipelined write stream to ``addr``'s blockport.
        The final response dict, or None when the peer cannot take a stream
        (the caller then sends the whole block). Transport failures raise
        UNAVAILABLE and open the address's breaker."""
        if not enabled():
            return None
        try:
            timeout = attempt_timeout(timeout)
        except BudgetExhausted:
            raise RpcError(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                f"deadline budget exhausted before WriteStream to {addr}",
            ) from None
        port = await self._data_port(rpc, addr, service)
        if port is None or not self._stream.get(addr, False):
            return None
        from tpudfs_torch.common import writestream  # noqa: PLC0415 (cycle)

        host = addr.rsplit(":", 1)[0]
        hostport = f"{host}:{port}"
        try:
            conn = await self._checkout(hostport)
        except (OSError, ConnectionError) as e:
            self._ports.pop(addr, None)
            self.breakers.record_failure(addr)
            raise RpcError(grpc.StatusCode.UNAVAILABLE,
                           f"write stream dial {hostport}: {e!r}") from None
        r, w = conn
        header = dict(req)
        rem = remaining_budget()
        if rem is not None:
            header["_db"] = rem
        tenant = raw_tenant()
        if tenant is not None:
            header[TENANT_FRAME_KEY] = tenant
        try:
            resp = await asyncio.wait_for(
                writestream.send_block_stream(r, w, header, data),
                timeout=timeout)
        except RpcError as e:
            if getattr(e, "stream_clean", False):
                # Rejected before any data frame: the connection is still
                # framed — reuse it.
                self._release(hostport, conn)
                if e.code == grpc.StatusCode.UNIMPLEMENTED:
                    self._stream[addr] = False
                    return None
            else:
                w.close()
            raise
        except asyncio.TimeoutError:
            w.close()
            raise RpcError(grpc.StatusCode.DEADLINE_EXCEEDED,
                           f"write stream to {hostport} timed out") from None
        except asyncio.CancelledError:
            w.close()
            raise
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                ValueError, msgpack.exceptions.UnpackException) as e:
            w.close()
            self._ports.pop(addr, None)
            self.breakers.record_failure(addr)
            raise RpcError(grpc.StatusCode.UNAVAILABLE,
                           f"write stream {hostport}: {e!r}") from None
        self.breakers.record_success(addr)
        self._release(hostport, conn)
        return resp

    async def call(self, rpc: RpcClient, addr: str, service: str,
                   method: str, req: dict, timeout: float = 30.0,
                   payload_into=None) -> dict:
        """Blockport when advertised, gRPC otherwise. ``req["data"]`` (if
        any) travels as the raw payload. ``payload_into``: scatter callback
        for the response payload, honored on the blockport only (the gRPC
        path returns ``resp["data"]``)."""
        try:
            timeout = attempt_timeout(timeout)
        except BudgetExhausted:
            raise RpcError(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                f"deadline budget exhausted before {method} to {addr}",
            ) from None
        port = None
        if enabled():
            port = await self._data_port(rpc, addr, service)
        if port is None:
            return await rpc.call(addr, service, method, req, timeout=timeout)
        host = addr.rsplit(":", 1)[0]
        try:
            resp = await asyncio.wait_for(
                self._call_blockport(f"{host}:{port}", method, req,
                                     payload_into),
                timeout=timeout)
        except RpcError:
            raise
        except asyncio.TimeoutError:
            raise RpcError(grpc.StatusCode.DEADLINE_EXCEEDED,
                           f"blockport call to {host}:{port} timed out") \
                from None
        except (OSError, ConnectionError, asyncio.IncompleteReadError,
                ValueError, msgpack.exceptions.UnpackException) as e:
            # Connection or framing failure: forget the port (the peer may
            # have restarted elsewhere), open the breaker, and raise the
            # UNAVAILABLE the gRPC path would.
            self._ports.pop(addr, None)
            self.breakers.record_failure(addr)
            raise RpcError(grpc.StatusCode.UNAVAILABLE,
                           f"blockport {host}:{port}: {e!r}") from None
        self.breakers.record_success(addr)
        return resp

    async def _checkout(self, hostport: str):
        """A pooled connection to ``hostport``, or a fresh one."""
        free = self._free.setdefault(hostport, [])
        while free:
            conn = free.pop()
            if conn[1].is_closing():
                continue
            return conn
        host, port = hostport.rsplit(":", 1)
        conn = await asyncio.open_connection(
            host, int(port), ssl=self._ssl_ctx,
            server_hostname=host if self._ssl_ctx is not None else None,
            limit=_STREAM_LIMIT)
        sock = conn[1].get_extra_info("socket")
        if sock is not None:
            _tune_socket(sock)
        return conn

    def _release(self, hostport: str, conn) -> None:
        """Return a still-framed connection to the idle pool."""
        free = self._free.setdefault(hostport, [])
        if len(free) < self.MAX_IDLE_PER_PEER and not conn[1].is_closing():
            free.append(conn)
        else:
            conn[1].close()

    async def _call_blockport(self, hostport: str, method: str,
                              req: dict, payload_into=None) -> dict:
        conn = await self._checkout(hostport)
        r, w = conn
        try:
            header = {k: v for k, v in req.items() if k != "data"}
            header["m"] = method
            rem = remaining_budget()
            if rem is not None:
                header["_db"] = rem
            tenant = raw_tenant()
            if tenant is not None:
                header[TENANT_FRAME_KEY] = tenant
            w.writelines(_pack_frame(header, req.get("data")))
            await w.drain()
            resp, payload = await _read_frame(r, into=payload_into)
        except BaseException:
            w.close()
            raise
        self._release(hostport, conn)
        has_data = resp.pop("_d", 0)
        if not resp.pop("ok", False):
            raise _error_from_header(resp)
        if has_data:
            resp["data"] = payload
        return resp

    async def close(self) -> None:
        for conns in self._free.values():
            for _r, w in conns:
                w.close()
        self._free.clear()
