"""msgpack over gRPC — the client half of ``tpudfs/common/rpc.py``, the
port's own copy.

Every service of the cluster (master, chunkserver, config server) hosts
generic gRPC methods whose requests and responses are msgpack maps, so a
client needs no generated code: ``RpcClient.call(addr, service, method,
request)``. Messages may be up to 100 MB (the reference's cap): a 64 MiB
block is larger than gRPC's default limit.

Error conventions, as the reference's servers send them, both as
FAILED_PRECONDITION details:

- ``Not Leader|<hint_addr>`` — a Raft follower rejecting a write;
- ``REDIRECT:<shard_hint>`` — the key belongs to another shard.

Outgoing metadata carries the request id (``x-request-id``), the tenant
(``x-tenant``) and the remaining deadline budget (``x-deadline-budget``)
under the reference's keys (:mod:`tpudfs_torch.common.resilience`).
"""

from __future__ import annotations

import asyncio
import contextvars
import uuid
from dataclasses import dataclass
from typing import Any

import grpc
import grpc.aio
import msgpack

from tpudfs_torch.common.resilience import (
    DEADLINE_KEY,
    TENANT_KEY,
    BudgetExhausted,
    attempt_timeout,
    raw_tenant,
    remaining_budget,
    retry_after_hint,
)

MAX_MESSAGE_BYTES = 100 * 1024 * 1024

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]

#: Metadata key of the request id that correlates one operation's logs
#: across every hop (the reference's ``telemetry.REQUEST_ID_KEY``).
REQUEST_ID_KEY = "x-request-id"

_request_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpudfs_torch_request_id", default=None
)


def current_request_id() -> str:
    """The in-flight request id, minting one at the chain's origin."""
    rid = _request_id.get()
    if rid is None:
        rid = uuid.uuid4().hex[:16]
        _request_id.set(rid)
    return rid


def _dumps(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _loads(data: bytes) -> Any:
    return msgpack.unpackb(data, raw=False, strict_map_key=False)


class RpcError(Exception):
    """An RPC failure with a gRPC status code."""

    def __init__(self, code: grpc.StatusCode, message: str):
        super().__init__(message)
        self.code = code
        self.message = message

    @property
    def not_leader_hint(self) -> str | None:
        if self.message.startswith("Not Leader"):
            parts = self.message.split("|", 1)
            return parts[1] if len(parts) == 2 and parts[1] else None
        return None

    @property
    def redirect_hint(self) -> str | None:
        if self.message.startswith("REDIRECT:"):
            return self.message.split(":", 1)[1]
        return None

    @property
    def retry_after(self) -> float | None:
        """Server-suggested backoff when this is a load-shed rejection."""
        return retry_after_hint(self.message)


@dataclass
class ClientTls:
    ca_path: str
    cert_path: str | None = None
    key_path: str | None = None


class RpcClient:
    """Channel-caching msgpack gRPC client. Channels are created lazily,
    one per target address, inside the event loop that first calls it —
    so an ``RpcClient`` may be built before a process spawns workers."""

    def __init__(self, tls: ClientTls | None = None):
        #: public so the blockport pool reuses the same material
        self.tls = tls
        self._channels: dict[str, grpc.aio.Channel] = {}
        self._stubs: dict[tuple[str, str, str],
                          grpc.aio.UnaryUnaryMultiCallable] = {}
        self._lock: asyncio.Lock | None = None

    async def _channel(self, addr: str) -> grpc.aio.Channel:
        ch = self._channels.get(addr)
        if ch is not None:
            return ch
        if self._lock is None:
            self._lock = asyncio.Lock()
        async with self._lock:
            ch = self._channels.get(addr)
            if ch is not None:
                return ch
            if self.tls is not None:
                with open(self.tls.ca_path, "rb") as f:
                    root = f.read()
                cert = key = None
                if self.tls.cert_path and self.tls.key_path:
                    with open(self.tls.cert_path, "rb") as f:
                        cert = f.read()
                    with open(self.tls.key_path, "rb") as f:
                        key = f.read()
                creds = grpc.ssl_channel_credentials(
                    root_certificates=root, private_key=key,
                    certificate_chain=cert)
                ch = grpc.aio.secure_channel(addr, creds,
                                             options=_CHANNEL_OPTIONS)
            else:
                ch = grpc.aio.insecure_channel(addr, options=_CHANNEL_OPTIONS)
            self._channels[addr] = ch
            return ch

    async def call(self, addr: str, service: str, method: str, request: Any,
                   timeout: float | None = 10.0) -> Any:
        rpc = self._stubs.get((addr, service, method))
        if rpc is None:
            ch = await self._channel(addr)
            rpc = ch.unary_unary(f"/{service}/{method}",
                                 request_serializer=_dumps,
                                 response_deserializer=_loads)
            self._stubs[addr, service, method] = rpc
        metadata = ((REQUEST_ID_KEY, current_request_id()),)
        tenant = raw_tenant()
        if tenant is not None:
            metadata += ((TENANT_KEY, tenant),)
        # Per-attempt timeout = min(explicit timeout, remaining op budget);
        # the budget also rides metadata as relative seconds.
        try:
            timeout = attempt_timeout(timeout)
        except BudgetExhausted:
            raise RpcError(
                grpc.StatusCode.DEADLINE_EXCEEDED,
                f"deadline budget exhausted before calling {service}/{method}",
            ) from None
        rem = remaining_budget()
        if rem is not None:
            metadata += ((DEADLINE_KEY, f"{rem:.6f}"),)
        try:
            return await rpc(request, timeout=timeout, metadata=metadata)
        except grpc.aio.AioRpcError as e:
            raise RpcError(e.code(), e.details() or "") from None

    async def close(self) -> None:
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()
        self._stubs.clear()
