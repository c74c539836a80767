"""The DFS client — the port's own copy of ``tpudfs/client/client.py``.

It speaks to a live cluster over the wire only: msgpack over gRPC for the
control plane (:mod:`tpudfs_torch.common.rpc`) and the raw-TCP blockport
for block payloads (:mod:`tpudfs_torch.common.blocknet`), with the
reference's names, retries and error conventions:

- master RPC executor (``_execute``): shard-keyed targets, exponential
  backoff (500 ms doubling to a 5 s cap, 5 retries), ``Not Leader|<hint>``
  and ``REDIRECT:<shard>`` handling with a shard-map refresh, a per-target
  retry budget, and a time-limited ban (``REFUSED_TTL``) of masters that
  refused or timed out;
- write path (``create_file``): CreateFile with the first block allocated
  in the same round trip, AllocateBlock sticky to the creating master,
  CRC32C per block, 3x chains (streamed in frames over the blockport when
  every hop can take a stream) or RS(k, m) shards written in parallel,
  CompleteFile with per-block checksums and the ETag (md5, or CRC-64/NVME
  with ``etag_mode="crc64"``);
- read path: concurrent per-block fan-out, byte ranges mapped to block
  ranges, hedged replica reads (``hedge_delay``), EC reads with the
  data-shard concat fast path and the host RS decode otherwise;
- metadata: ``get_file_info`` coalesces concurrent callers into
  BatchGetFileInfo RPCs;
- the local short circuit (``local_reads``): a replica whose chunkserver
  shares this host's filesystem (proved with a nonce file) is read off disk
  through the port's own ``chunkserver/blockstore.py``.

The device paths of the port (``gpu/hbm_reader.py``, ``gpu/read_combiner.py``,
``gpu/checkpoint.py``, ``gpu/record_source.py``, ``gpu/wds.py``) take this
client, the colocated :class:`~tpudfs_torch.client.local.LocalClient`, or
any client with the same methods. The namespace calls include
``rename_file`` (a cross-shard rename is the masters' two-phase commit),
and the cluster-admin calls (``safe_mode_status``, ``set_safe_mode``,
``cluster_add_server``, ``cluster_remove_server``,
``cluster_transfer_leadership``, ``initiate_shuffle``, ``raft_state``)
send the reference's requests and return its answers.

A sharded deployment: give ``config_addrs`` and any masters; the client
fetches the shard map from the config group's leader on its first
``REDIRECT:`` or listing, routes each path to its shard's Raft group and
fans listings out over every shard. Unlike the reference's, a map fetch
follows a config follower's ``Not Leader|<hint>``, starts at the config
server that last answered, and keeps asking through a config-group
election (``SHARD_MAP_RETRY_S``): a client given only ``config_addrs``
works while the group elects, and a ``REDIRECT:`` to a shard the client
has not seen finds its peers. ``redirects`` and ``map_refreshes`` count
both. ``tls=ClientTls(...)`` puts every channel, gRPC and
blockport, under TLS.

Nothing here opens a socket before its first call, and every channel is
made inside the event loop that uses it, so a client may be built before a
process spawns loader workers (each worker builds its own).
"""

from __future__ import annotations

import asyncio
import hashlib
import time
import logging
import os
import uuid
from pathlib import Path

from tpudfs_torch.chunkserver.blockstore import BlockStore
from tpudfs_torch.client.local import (
    ChecksumMismatchError,
    DfsError,
    read_into_rows,
)
from tpudfs_torch.common import writestream
from tpudfs_torch.common.blocknet import BlockConnPool
from tpudfs_torch.common.checksum import crc32c, crc64nvme
from tpudfs_torch.common.erasure import decode as ec_decode
from tpudfs_torch.common.erasure import encode as ec_encode
from tpudfs_torch.common.resilience import (
    BreakerBoard,
    BudgetExhausted,
    RetryBudget,
    deadline_scope,
    remaining_budget,
    shielded_from_deadline,
    tenant_scope,
)
from tpudfs_torch.common.rpc import ClientTls, RpcClient, RpcError
from tpudfs_torch.common.sharding import ShardMap

logger = logging.getLogger(__name__)

DEFAULT_BLOCK_SIZE = 64 * 1024 * 1024
MAX_RETRIES = 5  # reference mod.rs:23
INITIAL_BACKOFF = 0.5  # reference mod.rs:24
BACKOFF_CAP = 5.0
#: How long a connection-refused/timed-out master stays deprioritized in
#: one call's retry loop — long enough to stop hint ping-pong against a
#: freshly killed leader, short enough that a node that failed DURING an
#: election is retried once it may have become the new leader.
REFUSED_TTL = 3.0

#: Seconds a shard-map fetch keeps asking the config group while no
#: config server answers it (an election takes one to three election
#: timeouts), clamped to the op's deadline budget.
SHARD_MAP_RETRY_S = 15.0

MASTER = "MasterService"
CS = "ChunkServerService"


#: ``DfsError`` and ``ChecksumMismatchError`` are the classes of
#: ``client/local.py``, so every client of the port raises one hierarchy;
#: the class names are the reference's, which the port matches by name.
__all__ = ["Client", "DfsError", "IndeterminateError",
           "ChecksumMismatchError", "OverloadedError"]


class IndeterminateError(DfsError):
    """The operation failed in a way where it MAY still have applied (retries
    exhausted on transport errors). Callers recording histories must treat
    this as a crash op, not a definite failure."""


class OverloadedError(DfsError):
    """The cluster shed this request (RESOURCE_EXHAUSTED) and in-call
    retries were used up. DETERMINATE — shed work was never executed. The
    S3 gateway maps this to 503 SlowDown; batch callers should back off and
    retry with jitter. ``retry_after`` carries the server's pacing hint
    (seconds) when the shed envelope included one, else ``None``."""

    def __init__(self, message: str, retry_after: float | None = None):
        super().__init__(message)
        self.retry_after = retry_after


def _budgeted(fn):
    """Public-op decorator: run inside the client's per-op deadline scope.

    With ``op_budget`` set, every RPC attempt, retry sleep and hedge under
    this operation is clamped to one shared remaining budget that also rides
    RPC metadata to every downstream hop. An ambient deadline from an outer
    caller always wins (deadline_scope only installs when none is active).
    The client's configured tenant identity is installed the same way, so
    per-op RPCs carry ``x-tenant``/``_tn`` unless an outer caller (the S3
    gateway's authenticated principal) already set one."""

    async def wrapped(self, *args, **kwargs):
        with deadline_scope(self.op_budget), tenant_scope(self.tenant):
            return await fn(self, *args, **kwargs)

    wrapped.__name__ = fn.__name__
    wrapped.__qualname__ = fn.__qualname__
    wrapped.__doc__ = fn.__doc__
    wrapped.__wrapped__ = fn
    return wrapped


def _uncovered(meta: dict, covered: int) -> DfsError:
    """A complete file whose block list holds fewer bytes than its size: a
    master that lost a block's metadata. The reference returns the short
    read as the file; the port refuses it."""
    return DfsError(f"{meta['path']}: its {len(meta['blocks'])} blocks hold "
                    f"{covered} of its {meta['size']} bytes")


class Client:
    #: ``_read_ec_shards`` lands shards in the caller's rows.
    lands_ec_rows = True

    def __init__(
        self,
        master_addrs: list[str] | None = None,
        config_addrs: list[str] | None = None,
        *,
        block_size: int = DEFAULT_BLOCK_SIZE,
        hedge_delay: float | None = None,
        max_retries: int = MAX_RETRIES,
        initial_backoff: float = INITIAL_BACKOFF,
        rpc_client: RpcClient | None = None,
        tls: ClientTls | None = None,
        rpc_timeout: float = 30.0,
        op_budget: float | None = None,
        host_aliases: dict[str, str] | None = None,
        local_reads: bool | None = None,
        etag_mode: str = "md5",
        tenant: str | None = None,
    ):
        if not master_addrs and not config_addrs:
            raise ValueError("need master_addrs or config_addrs")
        self.master_addrs = list(master_addrs or [])
        self.config_addrs = list(config_addrs or [])
        self.block_size = block_size
        #: Opt-in tail-latency hedging (reference with_hedge_delay mod.rs:76-79).
        self.hedge_delay = hedge_delay
        self.max_retries = max_retries
        self.initial_backoff = initial_backoff
        self.rpc_timeout = rpc_timeout
        #: Per-operation deadline budget (seconds). When set, every public
        #: op runs inside a deadline scope: per-attempt RPC timeouts and
        #: retry sleeps are clamped to the remaining budget, the budget
        #: rides RPC metadata to every downstream hop, and the op fails
        #: (bounded) instead of overshooting. None = legacy flat timeouts.
        self.op_budget = op_budget
        #: Tenant identity sent as metadata on every RPC this client makes
        #: (``x-tenant``/``_tn``) so server-side QoS charges this workload
        #: its own fair share. An ambient tenant from an outer caller (e.g.
        #: the S3 gateway's authenticated principal) always wins; None means
        #: the servers account the traffic to ``system``.
        self.tenant = tenant if tenant is not None else (
            os.environ.get("TPUDFS_TENANT") or None)
        #: Token-bucket retry throttle per target address: retries/hedges
        #: are capped at a fixed fraction of first-try volume so a slow
        #: server sees shrinking — not amplified — load.
        self.retry_budget = RetryBudget()
        #: Masters that refused or timed out, with the time their ban
        #: ends (``REFUSED_TTL``), shared by every call: a call starts at
        #: the first target not banned (see ``_execute``).
        self._refused: dict[str, float] = {}
        #: Per-replica-address circuit breakers biasing read ordering away
        #: from addresses that keep failing (ordering only — never drops
        #: the last candidate).
        self.breakers = BreakerBoard()
        #: "md5" (default — S3 md5-ETag conformance, reference mod.rs:430)
        #: or "crc64" (hardware CRC-64/NVME, ~50x cheaper on the put path;
        #: ETags then carry a "-crc64" suffix and are NOT content md5s).
        if etag_mode not in ("md5", "crc64"):
            raise ValueError(f"etag_mode must be md5|crc64, got {etag_mode!r}")
        self.etag_mode = etag_mode
        self._owns_rpc = rpc_client is None
        self.rpc = rpc_client or RpcClient(tls=tls)
        self.shard_map: ShardMap | None = None
        self._refreshing = False
        #: The config server that answered the last map fetch: the next
        #: fetch starts there.
        self._config_leader = self.config_addrs[0] if self.config_addrs \
            else None
        #: ``REDIRECT:`` answers followed, and shard-map fetches made.
        self.redirects = 0
        self.map_refreshes = 0
        #: Address rewriting applied just before dialing (reference host-alias
        #: indirection, mod.rs:86-99: cluster-internal addresses in the shard
        #: map / block locations are remapped to client-reachable ones — the
        #: Docker<->host case; also how the chaos harness interposes
        #: FaultProxy on shard-map-discovered routes).
        self.host_aliases = dict(host_aliases or {})
        #: Short-circuit local reads (HDFS-style; no reference equivalent):
        #: when a replica's chunkserver shares this host's filesystem —
        #: the north-star topology colocates chunkservers on GPU hosts —
        #: block bytes are pread directly with sidecar verification instead
        #: of traversing gRPC. Verified per-address with a nonce probe.
        if local_reads is None:
            local_reads = os.environ.get("TPUDFS_LOCAL_READS", "1") != "0"
        self.local_reads = local_reads
        #: addr -> (BlockStore|None, retry_at|None): conclusive probes are
        #: cached forever; transport failures carry a retry deadline.
        self._local_stores: dict[str, tuple[object | None, float | None]] = {}
        self._local_probe_lock = asyncio.Lock()
        #: Blocks served via the short-circuit path (observability/tests).
        self.local_read_blocks = 0
        #: Transparent coalescing of concurrent get_file_info calls into
        #: BatchGetFileInfo RPCs (see get_file_info).
        self.meta_coalescing = True
        self._meta_pending: list[tuple[str, asyncio.Future]] = []
        self._meta_drainer: asyncio.Task | None = None
        self._meta_tasks: set[asyncio.Task] = set()
        #: Raw-TCP bulk data plane for block payloads (common/blocknet);
        #: per-peer discovery with transparent gRPC fallback.
        self.block_pool = BlockConnPool(tls=self.rpc.tls)

    def _dial(self, addr: str) -> str:
        return self.host_aliases.get(addr, addr)

    async def _local_store(self, addr: str):
        """BlockStore reader for ``addr`` if it shares our filesystem, else
        None (cached either way)."""
        if not self.local_reads:
            return None
        cached = self._local_stores.get(addr)
        if cached is not None:
            store, retry_at = cached
            if store is not None or retry_at is None or \
                    asyncio.get_running_loop().time() < retry_at:
                return store
        async with self._local_probe_lock:  # no handshake stampede
            cached = self._local_stores.get(addr)
            if cached is not None:
                store, retry_at = cached
                if store is not None or retry_at is None or \
                        asyncio.get_running_loop().time() < retry_at:
                    return store
            store = None
            retry_at = None
            try:
                nonce = uuid.uuid4().hex
                resp = await self.rpc.call(
                    self._dial(addr), CS, "LocalAccess", {"nonce": nonce},
                    timeout=1.5,
                )
            except RpcError as e:
                # Transport errors / restarting / pre-feature servers: a
                # transient failure must not disable the fast path forever,
                # but re-probing on EVERY read would put a timeout-sized
                # stall ahead of the hedged RPC path whenever a replica is
                # down — negative-cache with an expiry instead.
                logger.debug("short-circuit probe of %s failed: %s",
                             addr, e.message)
                self._local_stores[addr] = (
                    None, asyncio.get_running_loop().time() + 30.0
                )
                return None
            probe = Path(resp["probe"])
            same_fs = False
            try:
                # Never unlink: the path is server-supplied, and deleting
                # it would hand a hostile server an arbitrary-file-delete
                # primitive on this host. The chunkserver GCs its own
                # probe files.
                same_fs = await asyncio.to_thread(
                    lambda: probe.read_bytes() == nonce.encode()
                )
            except OSError:
                pass
            if same_fs:
                store = BlockStore(resp["hot_dir"],
                                   resp["cold_dir"] or None)
            # A conclusive probe (shared or not) is cached permanently.
            self._local_stores[addr] = (store, retry_at)
            return store

    async def _read_local(self, addr: str, block_id: str, offset: int,
                          length: int, verify: bool = True, *, into=None):
        """Try the short-circuit path; None means use the RPC path.

        ``verify=False`` skips the host-side sidecar CRC pass — ONLY for
        callers that run their own end-to-end verification of the returned
        bytes (the device reader's CRC fold); otherwise a plain pread would
        silently return bit-rot. ``into``: as for ``_read_block_range``, the
        bytes land in ``into(nbytes)``, which is returned (the port's
        ``LocalClient`` reads the same way)."""
        store = await self._local_store(addr)
        if store is None:
            return None
        try:
            data = await asyncio.to_thread(
                store.read_verified if verify else store.read,
                block_id, offset, length or None, into=into,
            )
        except Exception as e:
            # Not-found (tiering move race, stale location) or corruption:
            # the RPC path handles both — and on corruption the chunkserver
            # side triggers its own recovery.
            logger.debug("short-circuit read of %s via %s failed: %s",
                         block_id, addr, e)
            return None
        self.local_read_blocks += 1
        return data

    async def close(self) -> None:
        await self.block_pool.close()
        if self._owns_rpc:
            await self.rpc.close()

    async def _data_call(self, addr: str, method: str, req: dict,
                         timeout: float, *,
                         allow_blockport: bool = True,
                         payload_into=None) -> dict:
        """Block-payload RPC to a chunkserver: blockport when the peer
        advertises one, gRPC otherwise. Aliased routes (host_aliases — the
        Docker/FaultProxy indirections) stay on gRPC so an interposer on
        the gRPC address can't be bypassed by the data side channel.
        ``allow_blockport=False`` forces gRPC (chain writers use it when
        the remaining chain isn't blockport-safe). ``payload_into``:
        blockport scatter callback for the response payload (blocknet
        _read_frame); on the gRPC path the payload still arrives as
        ``resp["data"]`` and the caller copies."""
        dialed = self._dial(addr)
        if dialed != addr or not allow_blockport:
            return await self.rpc.call(dialed, CS, method, req,
                                       timeout=timeout)
        return await self.block_pool.call(self.rpc, addr, CS, method, req,
                                          timeout=timeout,
                                          payload_into=payload_into)

    # ----------------------------------------------------------- shard map

    async def refresh_shard_map(self) -> bool:
        """Fetch the ShardMap from the config group's leader (reference
        mod.rs:1493-1534). The reference walks ``config_addrs`` from the
        first each time, drops a follower's ``Not Leader|<hint>`` and, when
        every config server refuses, keeps its old map (or none) without
        a word. Here a fetch starts at the config server that last
        answered, tries a hinted leader next, and rounds the group again
        with backoff until one answers or ``SHARD_MAP_RETRY_S`` (clamped
        to the op's deadline budget) runs out. Returns whether a map was
        installed."""
        if not self.config_addrs:
            return False
        self.map_refreshes += 1
        start = time.monotonic()
        stop = start + SHARD_MAP_RETRY_S
        rem = remaining_budget()
        if rem is not None:
            stop = min(stop, start + max(rem, 0.0))
        backoff, last = 0.1, "no config server asked"
        while True:
            queue = [self._config_leader] + [
                c for c in self.config_addrs if c != self._config_leader]
            tried: set[str] = set()
            while queue:
                cfg = queue.pop(0)
                if cfg in tried:
                    continue
                tried.add(cfg)
                try:
                    resp = await self.rpc.call(
                        self._dial(cfg), "ConfigService", "FetchShardMap",
                        {}, timeout=5.0)
                except RpcError as e:
                    last = f"{cfg}: {e.message}"
                    hint = e.not_leader_hint
                    if hint and hint not in tried:
                        queue.insert(0, hint)
                    continue
                self.shard_map = ShardMap.from_dict(resp["shard_map"])
                self._config_leader = cfg
                return True
            now = time.monotonic()
            if now >= stop:
                logger.warning("shard map fetch failed for %.1f s: %s",
                               now - start, last)
                return False
            await asyncio.sleep(min(backoff, stop - now))
            backoff = min(backoff * 2, 1.0)

    def _masters_for(self, path: str | None) -> list[str]:
        """Shard-keyed master targets; static list when unsharded."""
        if path is not None and self.shard_map is not None:
            shard = self.shard_map.get_shard(path)
            if shard is not None:
                peers = self.shard_map.get_peers(shard)
                if peers:
                    return peers
        if self.master_addrs:
            return list(self.master_addrs)
        if self.shard_map is not None:
            return self.shard_map.get_all_masters()
        return []

    def _masters_for_shard_hint(self, hint: str) -> list[str] | None:
        if self.shard_map is not None and self.shard_map.has_shard(hint):
            return self.shard_map.get_peers(hint)
        return None

    # --------------------------------------------------------- RPC executor

    @staticmethod
    async def _paced_sleep(delay: float) -> None:
        """Backoff sleep clamped to the remaining deadline budget. Raises
        BudgetExhausted when no budget remains — sleeping past the op's
        give-up point only converts a bounded failure into a late one."""
        rem = remaining_budget()
        if rem is not None:
            if rem <= 0:
                raise BudgetExhausted("deadline budget exhausted")
            delay = min(delay, rem)
        await asyncio.sleep(delay)

    async def _execute(self, method: str, req: dict, *, path: str | None = None,
                       masters: list[str] | None = None,
                       retry_benign: tuple[str, ...] = ()) -> tuple[dict, str]:
        """Retry/redirect loop (reference execute_rpc_internal mod.rs:1346-1488).
        Returns (response, master_that_answered).

        ``retry_benign``: status codes that, on a RETRY following an
        indeterminate failure, indicate the previous attempt actually applied
        (e.g. ALREADY_EXISTS after resending CreateFile) — treated as success.
        """
        targets = list(masters) if masters else self._masters_for(path)
        if not targets:
            await self.refresh_shard_map()
            targets = self._masters_for(path)
        if not targets:
            raise DfsError("no master addresses known")
        backoff = self.initial_backoff
        idx = 0
        #: Targets that refused/timed out recently, with EXPIRY times. A
        #: freshly killed leader keeps being named by its followers' "Not
        #: Leader" hints until the election completes; blindly following
        #: such a hint ping-pongs follower -> dead node -> follower with
        #: no backoff and burns the whole retry budget in a couple of
        #: seconds — faster than a live-cluster election. Hints naming a
        #: recently-unreachable node rotate to the next peer WITH backoff
        #: instead (found by chaos-roulette seed 3002/3003). The ban is
        #: TIME-limited, not per-call: a node that failed once DURING an
        #: election may be the healthy new leader seconds later, and a
        #: permanent ban would exclude it for the rest of a long call
        #: (test_chaos lease-window partition caught exactly that).
        #
        # The bans are the client's, not the call's: a call that started
        # at a dead master every time would deposit its first attempt's
        # retry token in the dead master's bucket and spend the retry from
        # the next target's, whose bucket no first attempt refills; once
        # it ran dry, every call on the shard failed at its first refusal
        # ("retry budget exhausted after attempt 1"). So a call starts at
        # the first target not banned.
        refused = self._refused

        def _refused(addr: str) -> bool:
            exp = refused.get(addr)
            if exp is None:
                return False
            if time.monotonic() >= exp:
                del refused[addr]
                return False
            return True

        def _rotate(i: int) -> int:
            # Advance PAST known-unreachable targets while any live
            # candidate remains — redialing the dead node every other
            # attempt would halve the election-length outage the retry
            # budget can ride out.
            i += 1
            if any(not _refused(t) for t in targets):
                while _refused(targets[i % len(targets)]):
                    i += 1
            return i

        if any(not _refused(t) for t in targets):
            while _refused(targets[idx % len(targets)]):
                idx += 1
        hint_follows = 0  # free immediate hint-follows used so far
        try:
            return await self._execute_attempts(
                method, req, targets, idx, refused, _refused, _rotate,
                hint_follows, backoff, retry_benign)
        except BudgetExhausted:
            raise IndeterminateError(
                f"{method}: deadline budget exhausted mid-retry"
            ) from None

    async def _execute_attempts(self, method, req, targets, idx, refused,
                                _refused, _rotate, hint_follows, backoff,
                                retry_benign) -> tuple[dict, str]:
        last_err: RpcError | None = None
        indeterminate = False  # a previous attempt may have applied
        for attempt in range(self.max_retries + 1):
            target = targets[idx % len(targets)]
            if attempt == 0:
                self.retry_budget.on_first_attempt(target)
            try:
                resp = await self.rpc.call(
                    self._dial(target), MASTER, method, req, timeout=self.rpc_timeout
                )
                return resp, target
            except RpcError as e:
                last_err = e
                hint = e.not_leader_hint
                redirect = e.redirect_hint
                if e.code.name in ("UNAVAILABLE", "DEADLINE_EXCEEDED"):
                    refused[target] = time.monotonic() + REFUSED_TTL
                if e.code.name == "RESOURCE_EXHAUSTED":
                    # Load-shed: DETERMINATE (the server refused before
                    # executing). Honor its retry-after pacing against the
                    # SAME target — rotating to a follower of the same Raft
                    # group only buys a Not-Leader bounce — and draw from
                    # the retry budget so shed->retry can't itself storm.
                    if attempt < self.max_retries and \
                            self.retry_budget.acquire_retry(target):
                        await self._paced_sleep(
                            max(e.retry_after or 0.0, backoff))
                        backoff = min(backoff * 2, BACKOFF_CAP)
                        continue
                    raise OverloadedError(
                        f"{method} shed by {target}: {e.message}",
                        retry_after=e.retry_after,
                    ) from None
                if hint and not _refused(hint):
                    # Leader hint: try it next. The first couple of
                    # follows are free (the normal one-hop redirect);
                    # beyond that, throttle — two LIVE not-yet-leaders
                    # hinting each other during a handoff would otherwise
                    # burn the whole budget at RPC speed (same defect
                    # class as the dead-leader ping-pong, between
                    # reachable peers).
                    if hint in targets:
                        idx = targets.index(hint)
                    else:
                        targets.insert(0, hint)
                        idx = 0
                    hint_follows += 1
                    if hint_follows > 2 and attempt < self.max_retries:
                        await self._paced_sleep(max(self.initial_backoff, 0.3))
                    continue
                if hint:
                    # Stale hint naming a recently-unreachable node: the
                    # likely cause is an election in progress, which
                    # resolves in ~one election timeout — wait a FLAT
                    # short interval (the escalating backoff is for
                    # overload, and stretches a ~2 s election window into
                    # ~12 s of sleeps) and rotate to a live peer. A
                    # Not-Leader rejection is DETERMINATE (the follower did
                    # not apply the op), so it must not set indeterminate —
                    # that flag stays tied to attempts that could actually
                    # have applied (UNAVAILABLE / DEADLINE_EXCEEDED / the
                    # generic fallthrough below).
                    idx = _rotate(idx)
                    if attempt < self.max_retries:
                        await self._paced_sleep(max(self.initial_backoff, 0.3))
                    continue
                if redirect is not None:
                    # Wrong shard: refresh the map FIRST, fall back to the
                    # stale map's peers only if the refresh fails
                    # (mod.rs:1442-1467).
                    self.redirects += 1
                    stale_peers = self._masters_for_shard_hint(redirect)
                    await self.refresh_shard_map()
                    peers = self._masters_for_shard_hint(redirect) or \
                        stale_peers or []
                    if peers:
                        targets = peers
                        idx = 0
                    continue
                logger.debug("rpc %s to %s failed: %s", method, target, e.message)
                if e.code.name in ("INVALID_ARGUMENT", "NOT_FOUND",
                                   "ALREADY_EXISTS", "DATA_LOSS",
                                   "OUT_OF_RANGE", "UNIMPLEMENTED"):
                    if indeterminate and e.code.name in retry_benign:
                        # The op we resent already applied on a prior attempt.
                        return {"success": True, "retry_resolved": True}, target
                    raise DfsError(e.message) from None
                indeterminate = True
                idx = _rotate(idx)
            if attempt < self.max_retries:
                # Every transport-error retry draws a token deposited by
                # first attempts (not-leader/redirect follows above are
                # ROUTING, exempt) — exhaustion means this client is in a
                # retry storm and the kindest thing is a fast bounded
                # failure.
                if not self.retry_budget.acquire_retry(
                        targets[idx % len(targets)]):
                    raise IndeterminateError(
                        f"{method}: retry budget exhausted after attempt "
                        f"{attempt + 1}: "
                        f"{last_err.message if last_err else 'unknown'}"
                    )
                await self._paced_sleep(backoff)
                backoff = min(backoff * 2, BACKOFF_CAP)
        raise IndeterminateError(
            f"{method} failed after {self.max_retries + 1} attempts: "
            f"{last_err.message if last_err else 'unknown'}"
        )

    # ------------------------------------------------------------ write path

    @_budgeted
    async def create_file(self, path: str, data: bytes,
                          ec: tuple[int, int] | None = None,
                          etag: str | None = None,
                          overwrite: bool = False,
                          attrs: dict | None = None) -> None:
        """Write ``data`` to ``path`` (reference create_file_from_buffer
        mod.rs:225-494; EC variant mod.rs:496-677). ``etag`` overrides the
        stored ETag (the S3 gateway stores plaintext/multipart ETags that
        differ from the md5 of the stored bytes); ``overwrite`` atomically
        replaces an existing file in the CreateFile command itself;
        ``attrs`` attaches small application key-values to the file
        metadata (the gateway's x-amz-meta-* user metadata)."""
        k, m = ec or (0, 0)
        resp, master = await self._execute("CreateFile", {
            "path": path, "ec_data_shards": k, "ec_parity_shards": m,
            "overwrite": overwrite, "first_block": True,
        }, path=path, retry_benign=("ALREADY_EXISTS",))
        # Fused first-block allocation (one master round-trip); absent on
        # alloc_error, retried resends, or pre-fusion masters — the
        # per-block AllocateBlock loop covers those.
        first_alloc = resp if resp.get("block") else None
        # A create that resolved via the ALREADY_EXISTS retry heuristic
        # never learned the surviving file's write token (it cannot know
        # whether that file is its own first attempt), so the strict
        # write-session fence will reject its token-less block writes at
        # apply time — recoverable below, not a hard failure.
        blind_resend = bool(resp.get("retry_resolved")) \
            and not resp.get("write_token")
        # One digest task for the whole put — the blind-resend retry below
        # reuses it instead of re-hashing the payload.
        etag_task = self._start_etag_task(data) if etag is None else None
        try:
            await self._write_blocks_and_complete(
                path, data, master, k, m, etag, attrs,
                first_alloc=first_alloc,
                token=str(resp.get("write_token") or ""),
                etag_task=etag_task,
            )
        except IndeterminateError:
            raise
        except (DfsError, RpcError) as e:
            # RpcError here means the DATA path died mid-write (e.g. every
            # chain entry unreachable): same indeterminate outcome as a
            # DfsError, and callers hold the DfsError contract — never the
            # transport exception.
            if blind_resend and "stale write session" in str(e):
                # Mint a fresh session with an atomic replace and retry
                # once: our payload wins exactly as it would have before
                # the fence existed (last-writer-wins create), instead of
                # the whole put deterministically failing with token "".
                # ANY failure here is indeterminate too — the path is
                # already visible with another session's (or partial)
                # content, so "nothing applied" would be a lie.
                try:
                    resp, master = await self._execute("CreateFile", {
                        "path": path, "ec_data_shards": k,
                        "ec_parity_shards": m,
                        "overwrite": True, "first_block": True,
                    }, path=path)
                    await self._write_blocks_and_complete(
                        path, data, master, k, m, etag, attrs,
                        first_alloc=resp if resp.get("block") else None,
                        token=str(resp.get("write_token") or ""),
                        etag_task=etag_task,
                    )
                    return
                except IndeterminateError:
                    raise
                except (DfsError, RpcError) as e2:
                    raise IndeterminateError(
                        f"write failed after namespace create for "
                        f"{path}: {e2}"
                    ) from e2
            # CreateFile already mutated the namespace: the path is visible
            # (empty/incomplete), so this failure is NOT "nothing applied".
            raise IndeterminateError(
                f"write failed after namespace create for {path}: {e}"
            ) from e

    def _start_etag_task(self, data: bytes) -> asyncio.Task:
        """ETag digest computed CONCURRENTLY with the block writes:
        hashlib releases the GIL, so the digest overlaps the chain-ack
        waits instead of serializing ~2 ms/MiB of single-core CPU in
        front of CompleteFile (the reference digests inline, mod.rs:430).
        The opt-in "crc64" mode swaps md5 for hardware CRC-64/NVME (~50x
        cheaper; the ETag is then NOT an md5 — callers that need S3
        md5-ETag conformance keep the default)."""
        if self.etag_mode == "crc64":
            fn = lambda: f"{crc64nvme(data):016x}-crc64"  # noqa: E731
        else:
            fn = lambda: hashlib.md5(data).hexdigest()  # noqa: E731
        task = asyncio.create_task(asyncio.to_thread(fn))
        task.add_done_callback(
            lambda t: None if t.cancelled() else t.exception()
        )
        return task

    async def _write_blocks_and_complete(self, path: str, data: bytes,
                                         master: str, k: int, m: int,
                                         etag: str | None,
                                         attrs: dict | None = None,
                                         first_alloc: dict | None = None,
                                         token: str = "",
                                         etag_task: asyncio.Task | None = None,
                                         ) -> None:
        if etag is None and etag_task is None:
            etag_task = self._start_etag_task(data)
        # Stick to the creating master for read-your-writes (mod.rs:256-266).
        sticky = [master] + [a for a in self._masters_for(path) if a != master]
        block_checksums = []
        # Zero-copy block framing: slicing the memoryview costs O(1)
        # where `data[off:off+block]` memcpys every block once more
        # before it even reaches a socket. Every consumer — crc32c,
        # ec_encode's frombuffer, msgpack bin packing, the blockport's
        # writelines — takes the view unchanged.
        view = memoryview(data)
        offset = 0
        while offset < len(data) or offset == 0:
            piece = view[offset : offset + self.block_size]
            if not piece and offset > 0:
                break
            if first_alloc is not None:
                alloc, first_alloc = first_alloc, None
            else:
                alloc, _ = await self._execute(
                    "AllocateBlock", {"path": path, "token": token},
                    masters=sticky,
                )
            block = alloc["block"]
            servers = alloc["chunk_server_addresses"]
            term = int(alloc.get("master_term") or 0)
            if not servers:
                raise DfsError("no chunk servers available")
            shard = str(alloc.get("shard_id") or "")
            piece_crc = crc32c(piece)
            if k > 0:
                await self._write_ec_block(block["block_id"], piece, servers,
                                           k, m, term, shard=shard)
            else:
                await self._write_replicated_block(
                    block["block_id"], piece, servers, term, crc=piece_crc,
                    shard=shard,
                )
            block_checksums.append({
                "block_id": block["block_id"],
                "checksum_crc32c": piece_crc,
                "actual_size": len(piece),
                "original_size": len(piece) if k > 0 else 0,
            })
            offset += len(piece) if piece else 1
            if not piece:
                break
        req = {
            "path": path,
            "size": len(data),
            "etag_md5": etag if etag is not None else await etag_task,
            "block_checksums": block_checksums,
            "token": token,
        }
        if attrs:
            req["attrs"] = dict(attrs)
        await self._execute("CompleteFile", req, masters=sticky)

    async def _write_replicated_block(self, block_id: str, data: bytes,
                                      servers: list[str], term: int,
                                      crc: int | None = None,
                                      shard: str = "") -> None:
        timeout = max(self.rpc_timeout, 60.0)
        # One CRC pass regardless of how many chain rotations the
        # failover loop below tries — the payload does not change.
        expected = crc if crc is not None else crc32c(data)
        resp = None
        last_err: RpcError | None = None
        # Chain-ENTRY failover: a dead/unreachable first hop rotates the
        # chain (relative order preserved) so the write proceeds through a
        # live entry with the dead member downstream, where the chain
        # tolerates hop failure and the healer repairs the replica count
        # (the reference's chain has the same one-sided tolerance:
        # chunkserver.rs:777-825 logs, not fails, a downstream error —
        # but its client gives up on a dead HEAD).
        for lead in range(len(servers)):
            chain = servers[lead:] + servers[:lead]
            req = {
                "block_id": block_id,
                "data": data,
                "next_servers": chain[1:],
                "expected_crc32c": expected,
                "master_term": term,
                "master_shard": shard,
            }
            first_hop_safe = False
            if self._dial(chain[0]) == chain[0]:
                # Chain transport choice: the native data-plane engine
                # forwards ONLY to blockports, so it may carry the chain
                # IFF every member advertises one; an asyncio-blockport
                # first hop re-resolves per hop (mixed chains fine);
                # otherwise gRPC so the handler chain picks transport
                # hop-by-hop — a mixed chain must never silently degrade
                # to fewer replicas.
                ports, first_hop_safe = await self.block_pool.chain_info(
                    self.rpc, chain, CS
                )
                if first_hop_safe and all(ports):
                    req["next_data_ports"] = ports[1:]
                    if writestream.MIN_STREAM_BYTES <= len(data) \
                            <= writestream.MAX_STREAM_BYTES \
                            and self.block_pool.stream_chain_ok(chain):
                        # Streaming entry: pipeline sub-block frames
                        # through the chain (writestream.py). A None
                        # result (peer can't stream after all) falls
                        # through to the whole-block path on the SAME
                        # rotation; UNAVAILABLE rotates like the
                        # whole-block path.
                        begin = writestream.begin_header(
                            block_id, len(data), expected_crc32c=expected,
                            master_term=term, master_shard=shard,
                            next_servers=chain[1:],
                            next_data_ports=ports[1:])
                        try:
                            resp = await self.block_pool.write_stream(
                                self.rpc, chain[0], CS, begin, data,
                                timeout=timeout)
                        except RpcError as e:
                            if e.code.name != "UNAVAILABLE":
                                raise
                            last_err = e
                            self.breakers.record_failure(chain[0])
                            logger.warning(
                                "chain entry %s unreachable (%s); rotating",
                                chain[0], e.message)
                            continue
                        if resp is not None:
                            break
            try:
                resp = await self._data_call(chain[0], "WriteBlock", req,
                                             timeout=timeout,
                                             allow_blockport=first_hop_safe)
                break
            except RpcError as e:
                # Rotation is only sound for a DEAD entry (refused/reset):
                # a DEADLINE_EXCEEDED entry may still be committing, and
                # resending through a second chain would run two chains
                # concurrently and stretch time-to-failure by R x timeout.
                if e.code.name != "UNAVAILABLE":
                    raise
                last_err = e
                self.breakers.record_failure(chain[0])
                logger.warning("chain entry %s unreachable (%s); rotating",
                               chain[0], e.message)
        if resp is None:
            raise last_err  # every candidate entry was unreachable
        if not resp.get("success"):
            raise DfsError(f"write failed: {resp.get('error_message')}")
        written = int(resp.get("replicas_written") or 0)
        if written < 1:
            raise DfsError("no replicas written")
        if written < len(servers):
            logger.warning(
                "block %s: only %d/%d replicas written (healer will repair)",
                block_id, written, len(servers),
            )

    async def _write_ec_block(self, block_id: str, data: bytes,
                              servers: list[str], k: int, m: int,
                              term: int, shard: str = "") -> None:
        """One shard per chunkserver, written in parallel with per-shard CRCs
        (reference mod.rs:308-412)."""
        if len(servers) < k + m:
            raise DfsError(f"EC({k},{m}) needs {k + m} servers, got {len(servers)}")
        shards = ec_encode(data, k, m)

        async def write_shard(i: int) -> None:
            resp = await self._data_call(servers[i], "WriteBlock", {
                "block_id": block_id,
                "data": shards[i],
                "next_servers": [],
                "expected_crc32c": crc32c(shards[i]),
                "master_term": term,
                "master_shard": shard,
            }, timeout=max(self.rpc_timeout, 60.0))
            if not resp.get("success"):
                raise DfsError(
                    f"EC shard {i} write failed: {resp.get('error_message')}"
                )

        await asyncio.gather(*(write_shard(i) for i in range(k + m)))

    # ------------------------------------------------------------- read path

    @_budgeted
    async def get_file_info(self, path: str) -> dict | None:
        """File metadata, transparently coalescing CONCURRENT callers into
        BatchGetFileInfo RPCs (one master round-trip, one ReadIndex/lease
        barrier, one msgpack envelope for the whole batch). Callers keep
        per-path semantics; batching only fuses the transport — under a
        read-heavy infeed the metadata plane otherwise pays a full RPC
        (~0.7 ms of the single bench core) per file. Disable with
        ``meta_coalescing=False`` for strict per-call RPCs."""
        if not self.meta_coalescing:
            return await self._get_file_info_single(path)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        fut.add_done_callback(
            lambda f: None if f.cancelled() else f.exception()
        )
        self._meta_pending.append((path, fut))
        if self._meta_drainer is None or self._meta_drainer.done():
            self._meta_drainer = asyncio.create_task(self._drain_meta())
        # The drainer is shared and deadline-shielded; each WAITER applies
        # its own budget here so a budgeted op stays bounded even when its
        # batch is stuck behind a slow shard.
        rem = remaining_budget()
        if rem is None:
            return await asyncio.shield(fut)
        try:
            return await asyncio.wait_for(asyncio.shield(fut), max(rem, 0.01))
        except asyncio.TimeoutError:
            raise IndeterminateError(
                f"get_file_info({path}): deadline budget exhausted waiting "
                "on metadata batch"
            ) from None

    async def _get_file_info_single(self, path: str) -> dict | None:
        resp, _ = await self._execute("GetFileInfo", {"path": path}, path=path)
        return resp["metadata"] if resp.get("found") else None

    async def _drain_meta(self) -> None:
        """Coalescer drain: rounds form naturally from whatever staged while
        the previous batch RPC was in flight (same pattern as the device read
        combiner). Paths are grouped by routing target set — different
        shards never share a batch."""
        # The drainer task inherits the contextvars of whichever caller
        # happened to spawn it, but it serves EVERY concurrent caller — one
        # op's deadline must not bound the shared batch RPC (waiters apply
        # their own budgets in get_file_info).
        with shielded_from_deadline():
            await self._drain_meta_rounds()

    async def _drain_meta_rounds(self) -> None:
        aborted = True
        try:
            while self._meta_pending:
                batch = self._meta_pending[:64]
                self._meta_pending = self._meta_pending[64:]
                groups: dict[tuple, list] = {}
                for path, fut in batch:
                    key = tuple(self._masters_for(path) or ())
                    groups.setdefault(key, []).append((path, fut))
                # Concurrent per-group RPCs: one slow/down shard's retry
                # loop must not head-of-line-block the other shards.
                await asyncio.gather(
                    *(self._run_meta_batch(items)
                      for items in groups.values())
                )
            aborted = False
        finally:
            self._meta_drainer = None
            if aborted:
                for _path, fut in self._meta_pending:
                    if not fut.done():
                        fut.set_exception(
                            DfsError("metadata coalescer shut down")
                        )
                self._meta_pending = []

    async def _run_meta_batch(self, items: list) -> None:
        try:
            resp, _ = await self._execute(
                "BatchGetFileInfo", {"paths": [p for p, _ in items]},
                path=items[0][0],
            )
            results = resp.get("results") or []
        except DfsError as e:
            # Pre-batch master (rolling upgrade): fall every path back to
            # the per-path RPC and stop coalescing against this cluster.
            # (grpc's generic handler words a missing method "Method not
            # found!"; UNIMPLEMENTED is fatal-not-retried in _execute.)
            if "unimplemented" in str(e).lower() or \
                    "method not found" in str(e).lower():
                self.meta_coalescing = False
                for path, fut in items:
                    task = asyncio.create_task(self._meta_fallback(path, fut))
                    self._meta_tasks.add(task)
                    task.add_done_callback(self._meta_tasks.discard)
                return
            for _path, fut in items:
                if not fut.done():
                    fut.set_exception(
                        DfsError(f"batched metadata fetch failed: {e!r}")
                    )
            return
        except BaseException as e:
            # Cancellation included: this batch was already sliced off
            # _meta_pending, so the drainer's abort cleanup can't reach
            # these futures — resolve them here or their shielded callers
            # hang forever.
            for _path, fut in items:
                if not fut.done():
                    fut.set_exception(
                        DfsError(f"batched metadata fetch failed: {e!r}")
                    )
            if not isinstance(e, Exception):
                raise
            return
        for i, (path, fut) in enumerate(items):
            r = results[i] if i < len(results) else {"retry": True}
            if r.get("retry"):
                # This shard couldn't serve the path (redirect /
                # migration); re-issue individually through the full
                # retry machinery. Keep a strong reference — the loop
                # holds tasks only weakly and a GC'd task would strand
                # the caller's future.
                task = asyncio.create_task(self._meta_fallback(path, fut))
                self._meta_tasks.add(task)
                task.add_done_callback(self._meta_tasks.discard)
            elif not fut.done():
                fut.set_result(r["metadata"] if r.get("found") else None)

    async def _meta_fallback(self, path: str, fut: asyncio.Future) -> None:
        try:
            result = await self._get_file_info_single(path)
        except BaseException as e:
            if not fut.done():
                fut.set_exception(
                    e if isinstance(e, Exception)
                    else DfsError("metadata fetch cancelled")
                )
            return
        if not fut.done():
            fut.set_result(result)

    @_budgeted
    async def get_file(self, path: str) -> bytes:
        """Concurrent block fan-out + reorder (reference mod.rs:856-917)."""
        meta = await self.get_file_info(path)
        if meta is None:
            raise DfsError(f"file not found: {path}")
        blocks = meta["blocks"]
        results: list[bytes | None] = [None] * len(blocks)

        async def fetch(i: int) -> None:
            results[i] = await self._read_block(blocks[i])

        await asyncio.gather(*(fetch(i) for i in range(len(blocks))))
        data = b"".join(results)  # type: ignore[arg-type]
        if len(data) < meta["size"]:
            raise _uncovered(meta, len(data))
        return data[: meta["size"]]

    @_budgeted
    async def read_file_range(self, path: str, offset: int, length: int) -> bytes:
        """Byte range → per-block (offset, length) reads (reference
        mod.rs:731-844)."""
        meta = await self.get_file_info(path)
        if meta is None:
            raise DfsError(f"file not found: {path}")
        return await self.read_meta_range(meta, offset, length)

    @_budgeted
    async def read_meta_range(self, meta: dict, offset: int, length: int) -> bytes:
        """Range read against already-fetched file metadata. Hot-path variant
        for callers (e.g. the grain infeed) that cache the immutable block
        layout and must not pay a master GetFileInfo round-trip per read."""
        if offset >= meta["size"] or length <= 0:
            return b""
        length = min(length, meta["size"] - offset)
        covered = sum(int(b["size"]) for b in meta["blocks"])
        if covered < offset + length:
            raise _uncovered(meta, covered)
        out: list[tuple[int, bytes]] = []
        pos = 0  # byte offset of current block start
        coros = []
        for i, block in enumerate(meta["blocks"]):
            bsize = block["size"]
            bstart, bend = pos, pos + bsize
            pos = bend
            lo = max(offset, bstart)
            hi = min(offset + length, bend)
            if lo >= hi:
                continue
            coros.append((lo, block, lo - bstart, hi - lo))

        async def fetch(entry):
            lo, block, boff, blen = entry
            if block.get("ec_data_shards"):
                whole = await self._read_ec_block(block)
                return lo, whole[boff : boff + blen]
            return lo, await self._read_block_range(block, boff, blen)

        parts = await asyncio.gather(*(fetch(e) for e in coros))
        for lo, chunk in parts:
            out.append((lo, chunk))
        out.sort()
        return b"".join(chunk for _, chunk in out)

    async def _read_block(self, block: dict) -> bytes:
        if block.get("ec_data_shards"):
            data = await self._read_ec_block(block)
        else:
            data = await self._read_block_range(block, 0, 0)
        expected = int(block.get("checksum_crc32c") or 0)
        if expected and crc32c(data) != expected:
            raise ChecksumMismatchError(
                f"end-to-end checksum mismatch for block {block['block_id']}"
            )
        return data

    async def _read_block_range(self, block: dict, offset: int,
                                length: int, *,
                                local_verify: bool = True,
                                into=None) -> bytes:
        """Replica read with optional hedging (reference read_block_range
        mod.rs:948-1107): fire the primary, start a delayed hedge at the
        second replica, first success wins; then sequential fallback.

        ``local_verify=False``: short-circuit reads skip the host sidecar
        CRC pass — only for callers doing their own end-to-end verify.

        ``into``: optional ``into(nbytes) -> writable buffer`` factory.
        On the blockport transport and the local short circuit the bytes
        land straight in that buffer (no intermediate ``bytes``), and the
        filled buffer is returned instead of ``bytes``. Each attempt
        (primary, hedge, fallback) gets its own buffer, so a losing
        hedge can never scribble over the winner's. The gRPC path still
        returns ``bytes``."""
        locations = [l for l in block["locations"] if l]
        if not locations:
            raise DfsError(f"no locations for block {block['block_id']}")
        # Breaker bias: replicas whose breakers are open (recent repeated
        # transport failures) go to the back of the candidate order. Pure
        # reordering — an all-open set is tried in place, so breakers can
        # never cost availability, only tail latency on known-bad peers.
        locations = self.breakers.healthy_first(locations)

        # Short-circuit: a colocated replica is read straight off disk
        # (verified against its sidecar) — no gRPC byte shuffling.
        for addr in locations:
            data = await self._read_local(
                addr, block["block_id"], offset, length, verify=local_verify,
                into=into,
            )
            if data is not None:
                return data

        req = {"block_id": block["block_id"], "offset": offset, "length": length}

        # ReadBlock is the chunkserver's VERIFIED RPC path: the server
        # checks the sidecar CRC32C before the bytes leave disk.
        async def read_from(addr: str) -> bytes:
            # Per-attempt sink: the scatter callback fills a fresh
            # caller-provided buffer, so the winner's result is its own
            # allocation even when a cancelled hedge raced it.
            sink = None

            def _scatter(header: dict, plen: int):
                nonlocal sink
                if not header.get("ok"):
                    return None  # error frame: let the transport read it
                sink = into(plen)
                return [memoryview(sink)]

            try:
                resp = await self._data_call(
                    addr, "ReadBlock", req,
                    timeout=max(self.rpc_timeout, 60.0),
                    payload_into=_scatter if into is not None else None)
            except RpcError as e:
                # Only transport-shaped failures feed the breaker — a
                # NOT_FOUND replica is a placement problem, not a sick peer.
                if e.code.name in ("UNAVAILABLE", "DEADLINE_EXCEEDED",
                                   "RESOURCE_EXHAUSTED"):
                    self.breakers.record_failure(addr)
                raise
            self.breakers.record_success(addr)
            if sink is not None:
                return sink
            return resp["data"]

        errors: list[str] = []
        self.retry_budget.on_first_attempt(locations[0])
        if self.hedge_delay is not None and len(locations) > 1:
            primary = asyncio.create_task(read_from(locations[0]))
            try:
                return await asyncio.wait_for(
                    asyncio.shield(primary), self.hedge_delay
                )
            except asyncio.TimeoutError:
                # A hedge is a speculative retry: it fires only if a budget
                # token is available, so hedge volume obeys the same
                # amplification cap as failure retries — under overload the
                # hedges are the first thing to go (graceful degradation).
                if not self.retry_budget.acquire_retry(locations[1]):
                    try:
                        return await primary
                    except RpcError as e:
                        errors.append(f"{locations[0]}: {e.message}")
                        rest = locations[1:]
                else:
                    hedge = asyncio.create_task(read_from(locations[1]))
                    done, pending = await asyncio.wait(
                        {primary, hedge}, return_when=asyncio.FIRST_COMPLETED
                    )
                    # Prefer any successful completion; cancel the loser.
                    winner: bytes | None = None
                    for t in done:
                        if t.exception() is None:
                            winner = t.result()
                    if winner is None and pending:
                        t2 = await asyncio.wait(pending)
                        for t in t2[0]:
                            if t.exception() is None:
                                winner = t.result()
                        pending = set()
                    for t in pending:
                        t.cancel()
                    if winner is not None:
                        return winner
                    errors.append("hedged reads failed")
                    rest = locations[2:]
            except RpcError as e:
                errors.append(f"{locations[0]}: {e.message}")
                rest = locations[1:]
            else:  # pragma: no cover
                rest = []
        else:
            rest = locations

        for addr in rest:
            try:
                return await read_from(addr)
            except RpcError as e:
                errors.append(f"{addr}: {e.message}")
        raise DfsError(
            f"all replicas failed for block {block['block_id']}: {errors}"
        )

    async def _read_ec_shards(self, block: dict, *,
                               local_verify: bool = True,
                               reasons: list | None = None,
                               rows=None) -> list:
        """Concurrent fetch of all k+m shard slots; None per missing shard
        (reference read_ec_block's fan-out, mod.rs:1110-1150). ``reasons``
        (if given) collects one per-slot failure description — decode
        failures are rare enough that the error must carry WHY each slot
        was missing. ``rows``: as for ``LocalClient._read_ec_shards``, the
        shards read into the caller's k landing rows, parity only in place
        of a missing data shard; a shard served over RPC comes back as
        ``bytes``."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        locations = block["locations"]

        async def fetch(i: int, into=None) -> bytes | None:
            addr = locations[i] if i < len(locations) else ""
            if not addr:
                if reasons is not None:
                    reasons.append(f"shard {i}: empty location")
                return None
            local = await self._read_local(addr, block["block_id"], 0, 0,
                                           verify=local_verify, into=into)
            if local is not None:
                return local
            try:
                resp = await self._data_call(
                    addr, "ReadBlock",
                    {"block_id": block["block_id"], "offset": 0, "length": 0},
                    timeout=max(self.rpc_timeout, 60.0),
                )
                return resp["data"]
            except RpcError as e:
                logger.warning("EC shard %d fetch failed: %s", i, e.message)
                if reasons is not None:
                    reasons.append(f"shard {i}@{addr}: {e.message}")
                return None

        if rows is not None:
            return await read_into_rows(fetch, k, m, rows)
        return list(await asyncio.gather(*(fetch(i) for i in range(k + m))))

    # Shards arrive via _read_ec_shards → _read_local (sidecar-verified) or
    # the ReadBlock RPC (server-side verified); decode failures raise.
    async def _read_ec_block(self, block: dict) -> bytes:
        """Concurrent shard fetch; concat fast path when all data shards
        arrive, RS decode otherwise (reference read_ec_block mod.rs:1110-1165)."""
        k = int(block["ec_data_shards"])
        m = int(block["ec_parity_shards"])
        original = int(block.get("original_size") or block.get("size") or 0)
        reasons: list = []
        shards = await self._read_ec_shards(block, reasons=reasons)
        if all(s is not None for s in shards[:k]):
            return b"".join(shards[:k])[:original]  # type: ignore[arg-type]
        try:
            return ec_decode(shards, k, m, original)
        except Exception as e:
            raise DfsError(
                f"EC decode failed for block {block['block_id']}: {e}; "
                f"locations={block.get('locations')}; "
                f"slot failures: {reasons or 'none recorded'}"
            ) from None

    # -------------------------------------------------------- namespace ops

    @_budgeted
    async def delete_file(self, path: str) -> None:
        await self._execute("DeleteFile", {"path": path}, path=path,
                            retry_benign=("NOT_FOUND",))

    @_budgeted
    async def rename_file(self, src: str, dst: str,
                          replace: bool = False) -> None:
        """``replace=True`` atomically swaps out an existing destination
        (the S3 gateway's PUT-overwrite publish step)."""
        await self._execute("Rename", {"src": src, "dst": dst,
                                       "replace": replace}, path=src,
                            retry_benign=("NOT_FOUND",))

    @_budgeted
    async def publish_checkpoint(self, base: str, step: int,
                                 src: str, dst: str) -> bool:
        """Atomically publish a staged checkpoint manifest (phase two of
        the two-phase checkpoint commit, gpu/checkpoint.py). The
        master renames ``src`` to ``dst`` in one replicated command,
        enforcing monotonic steps per ``base`` and succeeding idempotently
        when the step is already published — so a retried/resumed commit
        converges instead of erroring. Returns True when THIS call
        published the step, False when it was already published."""
        resp, _ = await self._execute("PublishCheckpoint", {
            "base": base, "step": int(step), "src": src, "dst": dst,
        }, path=src)
        return not resp.get("already_published")

    @_budgeted
    async def list_files(self, prefix: str = "") -> list[str]:
        """Per-shard fan-out union (reference mod.rs:125-200)."""
        return [p for p, _ in await self.list_files_with_meta(prefix, meta=False)]

    @_budgeted
    async def list_files_with_meta(
        self, prefix: str = "", *, meta: bool = True,
        basename: str | None = None,
    ) -> list[tuple[str, dict | None]]:
        """Listing with per-key metadata for the S3 gateway's ListObjects
        (Size/ETag/LastModified without per-key GetFileInfo round trips).
        ``basename`` filters server-side to paths ending in that segment."""
        req = {"path": prefix, "with_meta": meta, "basename": basename}
        if self.shard_map is None and self.config_addrs:
            await self.refresh_shard_map()
        out: dict[str, dict | None] = {}

        def merge(resp: dict) -> None:
            metas = resp.get("metas") or [None] * len(resp["files"])
            out.update(zip(resp["files"], metas))

        if self.shard_map is None:
            resp, _ = await self._execute("ListFiles", req)
            merge(resp)
            return sorted(out.items())
        for shard in self.shard_map.get_all_shards():
            peers = self.shard_map.get_peers(shard) or []
            if not peers:
                continue
            try:
                resp, _ = await self._execute("ListFiles", req, masters=peers)
                merge(resp)
            except DfsError as e:
                logger.warning("list on shard %s failed: %s", shard, e)
        return sorted(out.items())

    # ------------------------------------------------------------ admin ops

    async def safe_mode_status(self) -> dict:
        resp, _ = await self._execute("SafeModeStatus", {})
        return resp

    async def set_safe_mode(self, enter: bool) -> None:
        await self._execute("EnterSafeMode" if enter else "ExitSafeMode", {})

    async def cluster_add_server(self, address: str) -> None:
        await self._execute("AddRaftNode", {"address": address})

    async def cluster_remove_server(self, address: str) -> None:
        await self._execute("RemoveRaftNode", {"address": address})

    async def cluster_transfer_leadership(self, target: str) -> None:
        await self._execute("TransferLeadership", {"target": target})

    async def initiate_shuffle(self, prefix: str) -> None:
        """Kick off background block re-spreading for a prefix (reference
        InitiateShuffle master.rs:3620-3660, CLI `shuffle` dfs_cli.rs:96)."""
        await self._execute("InitiateShuffle", {"prefix": prefix}, path=prefix)

    async def raft_state(self, master: str) -> dict:
        """``master``'s Raft status (``role``, ``term``, ``leader_id``,
        ``config``, ...), asked of that master alone."""
        return await self.rpc.call(self._dial(master), MASTER, "RaftState",
                                   {}, timeout=5.0)
