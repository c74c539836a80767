"""The collective write group: live DFS writes replicated over a ring of
device positions — port of ``tpudfs/tpu/write_group.py``.

When chunkservers colocate on the hosts of the accelerators, a chain write
whose replica chain matches the group's ring successors is staged here
instead of riding the TCP chain: pending chunk writes of every member batch
into :class:`IciReplicator` rounds, every received replica CRC-verifies on
its device, the ok bits are summed into one ack count, and each member
persists the replica groups its position received. Any unhealthy condition
— a dead member, a device error, a failed verify, a stale fencing term at
persist — fails the submitting write with :attr:`IciWriteGroup.Error`, and
the caller falls back to the TCP chain, so durability is never weaker than
the chain's.

The members are duck-typed: each has an ``address``, an ``ici_fallbacks``
count, an ``invalidate_cached(block_id)`` and an ``async
persist_ici_replica(block_id, data, master_term, master_shard) -> bool``.
The protocol has two halves. ``attach`` sets ``_ici_group`` and
``_ici_pos`` on the member; the other half, which submits a chain write
and catches the group's error, the reference keeps in its chunkserver
(``ChunkServer._try_ici_write``), where it names the JAX package's
exception class. So ``attach`` also binds the port's own copy of that body
(``tpudfs_torch.chunkserver.ici_member.try_ici_write``) on the member as
``_try_ici_write``: a reference chunkserver then serves collective writes
without JAX. The copy catches ``group.Error``, so a subclass that sets
:attr:`IciWriteGroup.Error` to another class keeps working.

Round geometry: one round carries ``B`` blocks of a uniform chunk count
``cpb`` from every position (short positions pad with zero blocks, whose
expected CRCs are the zero-chunk CRC, so the device verify stays uniform).
``B`` is bucketed to powers of two, as in the reference. Staging (copy and
per-chunk CRC of every slot, the native CRC) runs on a worker thread, as do
the host→device copies, the replicate launches, the one sync of the ack
count and every device→host drain. ``stage_s`` accumulates the wall seconds
of each step (the spans ``write_group.<step>``): ``stage``, ``h2d``,
``replicate`` (hops + verify launches, enqueued), ``acks`` (the one sync),
``drain``, ``persist``.
"""

from __future__ import annotations

import asyncio
import logging
import types
from dataclasses import dataclass

import numpy as np

from tpudfs_torch.chunkserver.ici_member import try_ici_write
from tpudfs_torch.common import native, trace
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_plain
from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu.crc32c_cuda import WORDS_PER_CHUNK
from tpudfs_torch.gpu.ici_replication import IciReplicator, _peer

logger = logging.getLogger(__name__)

#: CRC32C of 512 zero bytes — the expected CRC of every padding slot.
_ZERO_CHUNK_CRC = crc32c_plain(b"\x00" * CHECKSUM_CHUNK_SIZE)
#: The steps ``IciWriteGroup.stage_s`` times.
STAGES = ("stage", "h2d", "replicate", "acks", "drain", "persist")


class IciWriteError(Exception):
    """A collective round failed for this block; the caller falls back to
    the TCP chain."""


@dataclass
class _Pending:
    block_id: str
    data: bytes
    cpb: int
    master_term: int
    master_shard: str
    fut: asyncio.Future
    seq: int = 0  # global submission order (round-geometry fairness)


@dataclass
class _RoundStats:
    rounds: int = 0
    blocks: int = 0
    bytes: int = 0
    round_failures: int = 0
    last_acks: int = 0
    persist_failures: int = 0

    def as_gauges(self) -> dict[str, float]:
        return {
            "ici_rounds_total": float(self.rounds),
            "ici_blocks_total": float(self.blocks),
            "ici_bytes_total": float(self.bytes),
            "ici_round_failures_total": float(self.round_failures),
            "ici_persist_failures_total": float(self.persist_failures),
            "ici_last_acks": float(self.last_acks),
        }


class IciWriteGroup:
    """Per-process scheduler batching colocated chunk writes into chain
    replication rounds over the mesh.

    ``members`` lists the chunkserver addresses in flat POSITION order:
    position ``p`` belongs to ring ``p // ring_size`` at ring position
    ``p % ring_size``. The successor chain of a member is the next ``R-1``
    addresses around its own ring row, which is exactly the replica set a
    round produces.
    """

    #: Max blocks per position per round.
    MAX_BLOCKS_PER_ROUND = 8
    #: How long the scheduler waits after a first submission for the round
    #: to fill before launching (seconds).
    ROUND_ACCUMULATE_S = 0.002
    #: The exception every failed block raises (see the module docstring).
    Error = IciWriteError

    def __init__(self, mesh, members: list[str], replication: int = 3,
                 axis: str | None = None):
        self.mesh = mesh
        self.replicator = IciReplicator(mesh, replication, axis=axis)
        self.replication = replication
        self.axis = self.replicator.axis
        self.ring_size = mesh.shape[self.axis]
        total = int(mesh.devices.size)
        if len(members) != total:
            raise ValueError(
                f"{len(members)} members for a {total}-position mesh "
                "(need one chunkserver per position, in position order)")
        self.members = list(members)
        self._devices = mesh.positions()
        self._cs: dict[int, object] = {}  # flat position -> member
        self._queues: list[list[_Pending]] = [[] for _ in range(total)]
        self._kick = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closed = False
        self._seq = 0
        self.stats = _RoundStats()
        self.stage_s = dict.fromkeys(STAGES, 0.0)

    # ----------------------------------------------------------- membership

    def attach(self, cs, position: int) -> None:
        """Register the member living at flat position ``position`` and bind
        the port's ``_try_ici_write`` on it; a position is 'alive' while its
        member is attached."""
        if self.members[position] != cs.address:
            raise ValueError(
                f"position {position} belongs to {self.members[position]}, "
                f"not {cs.address}")
        self._cs[position] = cs
        cs._ici_group = self
        cs._ici_pos = position
        cs._try_ici_write = types.MethodType(try_ici_write, cs)

    def detach(self, position: int) -> None:
        cs = self._cs.pop(position, None)
        if cs is not None:
            cs._ici_group = None

    def healthy(self) -> bool:
        """Every position attached and the scheduler not shut down. A dead
        member flips the whole group to the TCP fallback until it
        re-attaches — replication must never silently drop below R."""
        return not self._closed and len(self._cs) == len(self.members)

    def successors(self, position: int) -> list[str]:
        """The R-1 ring successors of ``position`` — the replica set a round
        produces for its blocks, and therefore the ONLY chain this group
        may serve."""
        n = self.ring_size
        row = (position // n) * n
        return [self.members[row + ((position % n) + j) % n]
                for j in range(1, self.replication)]

    def ring_of(self, position: int) -> list[str]:
        """The ordered ring row containing ``position`` (advertised to the
        master via heartbeats for successor-chain placement)."""
        n = self.ring_size
        row = (position // n) * n
        return self.members[row : row + n]

    # ------------------------------------------------------------- staging

    async def submit(self, position: int, block_id: str, data: bytes,
                     master_term: int, master_shard: str) -> int:
        """Stage one block write from position ``position``; resolves with
        the number of replicas written once a round carried, verified and
        persisted it. Raises :attr:`Error` when the round failed — the
        caller falls back to the TCP chain."""
        if self._closed:
            raise self.Error("write group stopped")
        if not data:
            raise self.Error("empty block")
        cpb = -(-len(data) // CHECKSUM_CHUNK_SIZE)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        fut.add_done_callback(
            lambda f: None if f.cancelled() else f.exception()
        )
        self._seq += 1
        self._queues[position].append(_Pending(
            block_id=block_id, data=data, cpb=cpb,
            master_term=master_term, master_shard=master_shard, fut=fut,
            seq=self._seq,
        ))
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._scheduler())
        self._kick.set()
        return await asyncio.shield(fut)

    async def stop(self) -> None:
        self._closed = True
        task = self._task
        if task is not None and not task.done():
            self._kick.set()
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            except Exception:
                logger.exception("write-group scheduler failed during stop")
        for q in self._queues:
            for p in q:
                if not p.fut.done():
                    p.fut.set_exception(self.Error("write group stopped"))
            q.clear()

    # ------------------------------------------------------------ scheduler

    async def _scheduler(self) -> None:
        while not self._closed:
            if not any(self._queues):
                self._kick.clear()
                await self._kick.wait()
                continue
            # Let a burst of submissions from concurrent writers land so
            # the round is dense.
            await asyncio.sleep(self.ROUND_ACCUMULATE_S)
            try:
                await self._run_round()
            except asyncio.CancelledError:
                raise
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("collective write round crashed: %s", e)

    def _take_round(self) -> tuple[int, int, list[list[_Pending]]]:
        """Pick geometry and drain this round's blocks: uniform ``cpb``
        taken from the GLOBALLY oldest pending block (by submission seq —
        head-of-first-queue would starve a minority-geometry block on a
        later position behind a busy earlier one), up to a power-of-two
        ``B`` blocks per position."""
        oldest = min((q[0] for q in self._queues if q),
                     key=lambda p: p.seq)
        cpb = oldest.cpb
        per_pos: list[list[_Pending]] = []
        most = 1
        for q in self._queues:
            take = [p for p in q if p.cpb == cpb][: self.MAX_BLOCKS_PER_ROUND]
            per_pos.append(take)
            most = max(most, len(take))
        B = 1 << (most - 1).bit_length()  # pow2 bucket: bounded shapes
        for q, take in zip(self._queues, per_pos):
            taken = set(map(id, take))
            q[:] = [p for p in q if id(p) not in taken]
        return cpb, B, per_pos

    async def _run_round(self) -> None:
        """One collective round. EVERY pending drained by _take_round is
        resolved before this returns or re-raises: once a block leaves its
        queue, neither stop()'s sweep nor the scheduler's crash guard can
        see it, so an unresolved future here would strand its writer."""
        cpb, B, per_pos = self._take_round()
        try:
            await self._round_body(cpb, B, per_pos)
        except asyncio.CancelledError:
            self._fail_round(per_pos, "write group stopped")
            raise
        except Exception as e:
            self.stats.round_failures += 1
            self._fail_round(per_pos, f"collective round failed: {e}")
        finally:
            # _round_body resolves futures on every path it knows about;
            # anything it missed fails out here.
            self._fail_round(per_pos, "round ended without a verdict")

    async def _timed(self, step: str, fn):
        """``fn()`` on a worker thread, its wall seconds added to
        ``stage_s[step]``."""
        async with trace.span(f"write_group.{step}", stages=self.stage_s):
            return await asyncio.to_thread(fn)

    def _stage(self, C: int, cpb: int, per_pos) -> tuple[list, list]:
        """Per position: (C, 128) words with each block at its slot, and
        the (C,) expected CRCs of every padded slot (zero-chunk CRCs for
        the empty ones), computed by the native CRC."""
        stride = cpb * CHECKSUM_CHUNK_SIZE
        words, crcs = [], []
        for take in per_pos:
            w = np.zeros((C, WORDS_PER_CHUNK), dtype="<u4")
            c = np.full(C, _ZERO_CHUNK_CRC, dtype="<u4")
            flat = w.reshape(-1).view(np.uint8)
            for j, p in enumerate(take):
                off = j * stride
                flat[off : off + len(p.data)] = np.frombuffer(p.data,
                                                              dtype=np.uint8)
                c[j * cpb : (j + 1) * cpb] = native.crc32c_chunks(
                    flat[off : off + stride])
            words.append(w)
            crcs.append(c)
        return words, crcs

    async def _round_body(self, cpb: int, B: int,
                          per_pos: list[list[_Pending]]) -> None:
        total = len(self.members)
        C = B * cpb
        try:
            words, crcs = await self._timed(
                "stage", lambda: self._stage(C, cpb, per_pos))
            dwords, dcrcs = await self._timed("h2d", lambda: (
                [host_to_device(w, d) for w, d in zip(words, self._devices)],
                [host_to_device(c, d) for c, d in zip(crcs, self._devices)]))
            del words, crcs
            replicas, _ok, acks = await self._timed(
                "replicate",
                lambda: self.replicator.replicate(dwords, dcrcs))
            acks = await self._timed("acks", lambda: int(acks))
        except Exception as e:
            self.stats.round_failures += 1
            self._fail_round(per_pos, f"collective round failed: {e}")
            return
        self.stats.last_acks = acks
        if acks != total:
            # Some position's device verify failed — a corrupt transfer or
            # a garbage member. The whole round falls back: partial persists
            # would hand the master replica sets the ring never produced.
            self.stats.round_failures += 1
            self._fail_round(per_pos,
                             f"round verified on {acks}/{total} positions")
            return
        written, local_ok = await self._persist_round(replicas, per_pos, cpb)
        self.stats.rounds += 1
        for pos, take in enumerate(per_pos):
            for p in take:
                n = written.get((pos, p.block_id), 0)
                if n > 0 and (pos, p.block_id) in local_ok:
                    self.stats.blocks += 1
                    self.stats.bytes += len(p.data)
                    if not p.fut.done():
                        p.fut.set_result(n)
                elif not p.fut.done():
                    p.fut.set_exception(self.Error(
                        f"persist failed for {p.block_id} "
                        f"({n}/{self.replication} copies)"))

    async def _persist_round(self, replicas, per_pos, cpb: int):
        """Each member drains ITS position's replicas — group r on position
        p holds the blocks of ring position p - r — and persists them
        through its fenced path. Returns
        ({(source_pos, block_id): copies_persisted}, local_ok), where
        local_ok holds the (source_pos, block_id) pairs whose SOURCE member
        persisted its own copy — the analogue of the TCP chain's local
        write; without it the write fails over to the TCP path."""
        n = self.ring_size
        written: dict = {}
        local_ok: set = set()
        jobs = []
        def drain(p: int, rep) -> list:
            """Position p's (R, C, 128) replicas to the host, cut into one
            bytes object per block it holds."""
            local = u32_to_numpy(rep).reshape(self.replication, -1) \
                .view(np.uint8)
            out = []
            for r in range(self.replication):
                src = _peer(p, n, -r)
                for j, pend in enumerate(per_pos[src]):
                    off = j * cpb * CHECKSUM_CHUNK_SIZE
                    out.append((src, pend, r,
                                local[r, off : off + len(pend.data)].tobytes()))
            return out

        for p, rep in enumerate(replicas):
            member = self._cs.get(p)
            if member is None:
                self.stats.persist_failures += 1
                continue
            for src, pend, r, raw in await self._timed(
                    "drain", lambda p=p, rep=rep: drain(p, rep)):
                jobs.append((src, pend, r, member, raw))

        async def persist(job):
            src, pend, r, member, data = job
            ok = await member.persist_ici_replica(
                pend.block_id, data, pend.master_term, pend.master_shard)
            return (src, pend.block_id, r, ok)

        async with trace.span("write_group.persist", stages=self.stage_s):
            results = await asyncio.gather(*(persist(j) for j in jobs))
        for src, bid, r, ok in results:
            if ok:
                written[(src, bid)] = written.get((src, bid), 0) + 1
                if r == 0:
                    local_ok.add((src, bid))
            else:
                self.stats.persist_failures += 1
        return written, local_ok

    def _fail_round(self, per_pos, msg: str) -> None:
        for take in per_pos:
            for p in take:
                if not p.fut.done():
                    p.fut.set_exception(self.Error(msg))

    # --------------------------------------------------------------- warmup

    def warm(self, cpb: int, max_blocks: int | None = None) -> None:
        """Run one zero round for every pow2 bucket up to ``max_blocks``, so
        the first live round pays no first-use cost (kernel libraries and
        constant tables loaded, device memory cached)."""
        b = 1
        cap = max_blocks or self.MAX_BLOCKS_PER_ROUND
        while b <= cap:
            C = b * cpb
            w = [host_to_device(np.zeros((C, WORDS_PER_CHUNK), dtype="<u4"), d)
                 for d in self._devices]
            c = [host_to_device(np.full(C, _ZERO_CHUNK_CRC, dtype="<u4"), d)
                 for d in self._devices]
            acks = int(self.replicator.replicate(w, c)[2])
            if acks != len(self.members):
                raise RuntimeError(f"warm-up round verified on {acks}/"
                                   f"{len(self.members)} positions")
            b <<= 1
