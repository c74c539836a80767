"""The checkpoint stages of the fault tiers, on the port's
``CheckpointManager`` — counterpart of ``tpudfs/testing/ckptchaos.py`` and
of the checkpoint stages of the JAX package's three fault tiers:

- the exploration gate's checkpoint scenario (``scripts/explore_gate.py``:
  ``_MemDfsClient``, ``scenario_ckpt``): :class:`MemDfsClient`,
  :func:`ckpt_scenario`;
- the live tier's kill-mid-checkpoint stage (``scripts/chaos_live.py``
  t10): :func:`kill_mid_checkpoint`, and its variant whose saver is
  never cancelled, :func:`kills_tear_checkpoint`;
- the roulette's checkpoint axis (``scripts/chaos_roulette.py``: the
  manager, ``checkpointer``, ``settle`` and the post-fault check):
  :func:`roulette_manager`, :func:`save_through_faults`,
  :func:`settle_and_verify`, with :func:`kill_plan` / :func:`run_kill_plan`
  for a seeded plan of chunkserver kills, and of master kills and
  shard-leader partitions on a sharded deployment (``shards=``, drawn as
  ``make_plan`` draws them; the partitions through
  :mod:`tpudfs_torch.netem`);
- and one stage of its own, :func:`rebuild_after_kills`: an EC-only
  checkpoint whose data-shard holders die, restored through the GF(2^8)
  rebuild.

Every assertion is "whatever step the cluster lists restores BIT-EXACT",
which works because :func:`ckpt_tree` regenerates the exact tensor tree of
any (step, shard) after the fact. Restores go through the caller's
:class:`~tpudfs_torch.gpu.hbm_reader.HbmReader` into device memory
(``cuda:0`` by default; the CPU when named), so every block is verified by
the CRC32C kernel and every lost data shard is rebuilt by the GF(2^8)
kernel on a card.

The port cannot build a cluster, an explorer or a history checker: the
client, the kill callbacks (sync or async), the recorder, the checker and
the violation class come from the caller. Errors are matched by class name
(``client/local.py::is_error_named``), never imported.
"""

from __future__ import annotations

import asyncio
import collections
import inspect
import json
import logging
import random
import time
from typing import NamedTuple

import numpy as np
import torch

from tpudfs_torch.client.local import DfsError, is_error_named
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.gpu import resolve_device
from tpudfs_torch.gpu.checkpoint import (
    CheckpointManager,
    IncompleteCheckpointError,
)
from tpudfs_torch.gpu.rs_cuda import gf_matmul_words
from tpudfs_torch.graft_entry import launch_counts, sync

logger = logging.getLogger(__name__)

_SEED = 0xC4F07


# ------------------------------------------------------------------ trees


def ckpt_tree(step: int, shard: int, *, kib: int = 96) -> dict:
    """The canonical tensor tree for (step, shard): ~``kib`` KiB split
    across float32 "weights", int32 "opt state" and an int8 tail (the
    int8 tensor is checked by its own CRC in the device restore)."""
    rng = np.random.default_rng(_SEED + 100_003 * step + shard)
    words = (kib * 1024) // 4
    w = words // 2
    o = words // 4
    return {
        "layer0/w": rng.standard_normal(w, dtype=np.float32),
        "opt/step_counts": rng.integers(0, 2**31 - 1, size=o, dtype=np.int32),
        "opt/flags": rng.integers(-128, 127, size=o, dtype=np.int8),
    }


def trees_equal(a: dict, b: dict) -> bool:
    """Bit-exact tree comparison (dtype + shape + every element); tensors
    on any device are compared through their host copies."""
    if sorted(a) != sorted(b):
        return False
    for name in a:
        x, y = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for v in (a[name], b[name]))
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
            return False
    return True


def assert_restores_bit_exact(trees: dict, step: int, *,
                              kib: int = 96) -> None:
    """``trees`` is ``CheckpointManager.restore()``'s ``{shard: tree}`` for
    ``step``; every shard must match its regenerated canonical tree
    (``kib`` as the saver passed it to :func:`ckpt_tree`)."""
    for shard, tree in trees.items():
        if not trees_equal(tree, ckpt_tree(step, shard, kib=kib)):
            raise AssertionError(
                f"checkpoint step {step} shard {shard} did not restore "
                "bit-exact")


def _trees(step: int, kib: int, num_shards: int = 2) -> dict:
    return {s: ckpt_tree(step, s, kib=kib) for s in range(num_shards)}


async def _call(fn, *args):
    """Call a sync or async callback and wait for it."""
    out = fn(*args)
    if inspect.isawaitable(out):
        out = await out
    return out


def is_fault(exc: BaseException) -> bool:
    """An error a save may die of while servers die or elect (the
    roulette's ``DfsError, BudgetExhausted, asyncio.TimeoutError,
    OSError``)."""
    return isinstance(exc, (asyncio.TimeoutError, OSError)) or any(
        is_error_named(exc, n) for n in ("DfsError", "BudgetExhausted"))


# ------------------------------------------------------- exploration gate


class MemDfsClient:
    """In-memory async stand-in for the client surface
    ``CheckpointManager`` uses. Each op suspends at least once so an
    explorer can interleave concurrent savers and readers mid-metadata."""

    block_size = 1 << 20
    tenant = None

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.meta: dict[str, dict] = {}

    async def _yield(self):
        await asyncio.sleep(0)

    def _stamp(self, path: str, data: bytes, etag: str | None):
        self.files[path] = bytes(data)
        self.meta[path] = {
            "size": len(data),
            "etag_md5": etag or f"mem-{len(data)}",
        }

    async def create_file(self, path, data, ec=None, etag=None,
                          overwrite=False, attrs=None):
        await self._yield()
        if not overwrite and path in self.files:
            raise DfsError(f"{path} exists")
        await self._yield()  # widen the metadata/payload window
        self._stamp(path, data, etag)

    async def get_file(self, path):
        await self._yield()
        if path not in self.files:
            raise DfsError(f"{path} not found")
        return self.files[path]

    async def get_file_info(self, path):
        await self._yield()
        return dict(self.meta[path]) if path in self.meta else None

    async def publish_checkpoint(self, base, step, src, dst) -> bool:
        await self._yield()
        if dst in self.files:
            return False  # idempotent re-publish
        body = self.files.get(src)
        if body is None:
            raise DfsError(f"staged manifest {src} missing")
        await self._yield()
        self._stamp(dst, body, None)
        return True

    async def list_files_with_meta(self, prefix, meta=True, basename=None):
        await self._yield()
        return sorted(
            (p, dict(self.meta[p]) if meta else None)
            for p in self.files if p.startswith(prefix))

    async def delete_file(self, path):
        await self._yield()
        self.files.pop(path, None)
        self.meta.pop(path, None)


def ckpt_scenario(recorder_cls, check_history, violation):
    """The gate's checkpoint scenario on the port's manager: stage→publish
    with a straggling shard save racing an external coordinator's commit,
    while a reader polls. Invariants: a listed step is fully durable (no
    torn step visible), the latest step never moves backwards (monotonic
    step fence), and the publish/list/latest history is linearizable.

    ``recorder_cls(clock)`` records the history (``invoke``, ``ret``,
    ``entries``), ``check_history(entries)`` judges it, and ``violation``
    is the exception class a broken invariant raises. Returns the
    zero-argument coroutine factory an explorer runs once a schedule."""
    base = "/ckpt/run"

    async def body():
        client = MemDfsClient()
        mgr = CheckpointManager(client, base, num_shards=2, ec=None,
                                hot_copies=True)
        loop = asyncio.get_running_loop()
        rec = recorder_cls(loop.time)

        def tree(step: int, shard: int) -> dict:
            return {"w": np.arange(8, dtype=np.float32) * (step + shard + 1)}

        async def commit_step(who: str, step: int) -> bool:
            e = rec.invoke(who, "ckpt_publish", base, value=step)
            try:
                await mgr.commit(step)
            except IncompleteCheckpointError:
                rec.ret(e, {"ok": False})  # may-drop for the checker
                return False
            rec.ret(e, {"ok": True})
            return True

        writer_done = asyncio.Event()

        async def writer():
            try:
                await asyncio.gather(mgr.save_shard(1, 0, tree(1, 0)),
                                     mgr.save_shard(1, 1, tree(1, 1)))
                await commit_step("writer", 1)
                # Step 2, the straggler: an external coordinator commits
                # while the shards are still saving. Verify-then-publish
                # fails that early commit; publish-before-durable exposes
                # a torn step until the saves land.
                commit_t = asyncio.ensure_future(
                    commit_step("coordinator", 2))
                save = asyncio.ensure_future(asyncio.gather(
                    mgr.save_shard(2, 0, tree(2, 0)),
                    mgr.save_shard(2, 1, tree(2, 1))))
                await commit_t
                await save
                await commit_step("writer", 2)
            finally:
                writer_done.set()

        def incomplete_reason(step: int) -> str | None:
            # Ground-truth durability over the fake client's state,
            # synchronous on purpose: it runs in the scheduler step of the
            # list that returned ``step``, so no torn window can slip
            # between the observation and the check.
            for shard in range(mgr.num_shards):
                spec_path = ckptpaths.shard_spec_path(base, step, shard)
                raw = client.files.get(spec_path)
                if raw is None:
                    return f"shard {shard} spec missing"
                spec = json.loads(raw)
                for path in (spec.get("path"), spec.get("ec_path")):
                    if path is None:
                        continue
                    info = client.meta.get(path)
                    if info is None or info.get("etag_md5") != spec["etag"] \
                            or int(info.get("size", -1)) != spec["size"]:
                        return f"shard {shard} payload {path} not durable"
            return None

        async def reader():
            prev_latest = None
            polls = 0
            last_seen = object()  # record reads only when the view moves,
            # else the spin-poll floods the linearizability search
            while not (writer_done.is_set() and polls >= 2):
                polls += 1
                if polls > 400:  # safety valve, never hit in practice
                    break
                record = False
                e = rec.invoke("reader", "ckpt_list", base)
                steps = await mgr.list_steps()
                if tuple(steps) != last_seen:
                    record = True
                    last_seen = tuple(steps)
                    rec.ret(e, tuple(steps))
                else:
                    rec.entries.remove(e)
                for step in steps:
                    reason = incomplete_reason(step)
                    if reason is not None:
                        raise violation(
                            f"torn checkpoint visible: step {step} is "
                            f"listed but incomplete ({reason})")
                latest = steps[-1] if steps else None
                if record:
                    e = rec.invoke("reader", "ckpt_latest", base)
                    rec.ret(e, latest)
                if prev_latest is not None and (
                        latest is None or latest < prev_latest):
                    raise violation(
                        f"step fence moved backwards: latest went "
                        f"{prev_latest} -> {latest}")
                if latest is not None:
                    prev_latest = latest
                await asyncio.sleep(0)

        await asyncio.gather(writer(), reader())
        res = check_history(rec.entries)
        if not res.linearizable and not res.exhausted:
            raise violation(
                f"checkpoint history not linearizable: {res.message}")

    return body


# ------------------------------------------------ kill mid-checkpoint (t10)


async def retry_until(what: str, op, deadline_s: float) -> float:
    """Retry ``op()`` once a second until it succeeds; raise after
    ``deadline_s``. Returns the seconds it took."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    while True:
        try:
            await op()
            return loop.time() - t0
        except Exception as e:
            if loop.time() - t0 > deadline_s:
                raise RuntimeError(
                    f"{what} did not complete within {deadline_s} s: "
                    f"{type(e).__name__}: {e}") from e
            await asyncio.sleep(1.0)


async def restore_checked(mgr, step: int, kib: int, device,
                          block_size: int | None = None) -> dict:
    """Restore ``step`` through ``mgr`` into ``device``, bit-exact. Given
    ``block_size``, on a card ``crc32c_blocks`` must launch at least once
    a full block. The seconds, GB/s (payload over the restore's wall
    time), full blocks (None without ``block_size``) and launches."""
    manifest = await mgr.read_manifest(step)
    size = sum(s["size"] for s in manifest["shards"])
    full = None if block_size is None else \
        sum(s["size"] // block_size for s in manifest["shards"])
    before = launch_counts()
    t0 = time.perf_counter()
    trees = await mgr.restore(step, device=device)
    sync(device)
    seconds = time.perf_counter() - t0
    assert_restores_bit_exact(trees, step, kib=kib)
    after = launch_counts()
    launched = {k: after[k] - before[k] for k in after}
    if device.type == "cuda" and full and launched["crc32c_blocks"] < full:
        raise AssertionError(f"step {step}: {full} full blocks restored, "
                             f"{launched}")
    return {"step": step, "seconds": seconds, "gbps": size / seconds / 1e9,
            "full_blocks": full, "launches": launched}


class PutLog:
    """``client`` with its ``create_file`` calls logged by path, so a stage
    can see a save's own progress: ``started(path)`` is set when a put of
    ``path`` begins, ``returned`` holds the puts that have returned.
    ``before[path]`` (a sync or async callable, run once) runs as the
    first put of ``path`` begins, before anything of it is sent."""

    def __init__(self, client):
        self._client = client
        self.calls: list[str] = []
        self.returned: set[str] = set()
        self.before: dict = {}
        self._started: dict[str, asyncio.Event] = {}

    def __getattr__(self, name):
        return getattr(self._client, name)

    def started(self, path: str) -> asyncio.Event:
        return self._started.setdefault(path, asyncio.Event())

    async def create_file(self, path, *args, **kwargs):
        self.calls.append(path)
        self.started(path).set()
        hook = self.before.pop(path, None)
        if hook is not None:
            await _call(hook)
        out = await self._client.create_file(path, *args, **kwargs)
        self.returned.add(path)
        return out


async def kill_mid_checkpoint(client, kill_first, kill_mid, *, base: str,
                              kib: int, reader, device=None,
                              resume_s: float = 60.0) -> dict:
    """The live tier's kill-mid-checkpoint stage. ``kill_first()`` stands
    in for the tier's earlier chunkserver kill: it kills one and returns
    once the master has dropped it (its liveness cutoff passed), so step 1
    of a hot-only 2-shard checkpoint lands on live servers only. Step 2 is
    then saved one shard after the other: shard 0 lands, shard 1's payload
    put begins, and ``kill_mid()`` kills two more while that put is on the
    wire (the save's own progress is the proof, not a timer). The saver
    dies with them: one loop turn after the kills begin, its save is cut
    where it stands, so step 2 is torn (shard 0 durable, shard 1 cut
    mid-put, nothing committed) on every run. Left to run, the reference client rotates its write chain past
    the dead servers and often finishes the put, and there would be
    nothing to resume. The save is then resumed until it completes,
    within ``resume_s``: shard 0, which had landed, must be skipped by its
    content ETag and never put again. The namespace must list exactly
    [1, 2], and each step must restore bit-exact through ``reader`` into
    ``device`` (``cuda:0`` by default).

    Hot-only on purpose, as in the reference: with three of five
    chunkservers dead, 3x replication degrades to the survivors while EC
    allocation would fail. Returns whether the kills landed mid-save
    (``mid_save``: shard 1's put had begun and not returned when the
    saver was cut), whether the save ended unfinished (``interrupted``:
    cut, or failed on its own), the resume's seconds and payload puts a shard, the
    manager's ``shards_skipped`` and ``degraded_shard_reads``, and each
    step's restore seconds."""
    device = resolve_device(device)
    log = PutLog(client)
    mgr = CheckpointManager(log, base, num_shards=2, ec=None, reader=reader)
    trees = {s: _trees(s, kib) for s in (1, 2)}
    paths = {s: ckptpaths.shard_data_path(base, 2, s) for s in (0, 1)}
    await _call(kill_first)
    t0 = time.perf_counter()
    await mgr.save(1, trees[1])
    baseline_s = time.perf_counter() - t0

    await mgr.save_shard(2, 0, trees[2][0])

    async def save_rest() -> None:
        await mgr.save_shard(2, 1, trees[2][1])
        await mgr.commit(2)

    save = asyncio.ensure_future(save_rest())
    await log.started(paths[1]).wait()
    # The kills begin while shard 1's put is on the wire and the saver is
    # cut one loop turn later, however long an async ``kill_mid`` takes.
    killing = asyncio.ensure_future(_call(kill_mid))
    await asyncio.sleep(0)
    mid_save = paths[1] not in log.returned and not save.done()
    save.cancel()
    (outcome,) = await asyncio.gather(save, return_exceptions=True)
    interrupted = isinstance(outcome, BaseException)
    await killing
    logger.info("step 2: kills %s; save %s", "mid-save" if mid_save
                else "missed the save window",
                "ended unfinished" if interrupted else "had finished")

    puts_before = len(log.calls)
    resumed_s = await retry_until("step-2 resume",
                             lambda: mgr.save(2, trees[2]), resume_s)
    resume_puts = {s: log.calls[puts_before:].count(p)
                   for s, p in paths.items()}
    if resume_puts[0]:
        raise AssertionError(
            f"the resume put shard 0 again ({resume_puts[0]}x) although it "
            "had landed before the kills")
    steps = await mgr.list_steps()
    if steps != [1, 2]:
        raise AssertionError(
            f"namespace lists {steps}, want [1, 2]: a torn or missing "
            "checkpoint is visible")
    restore_s = {s: (await restore_checked(mgr, s, kib, device))["seconds"]
                 for s in steps}
    return {"mid_save": mid_save, "interrupted": interrupted,
            "baseline_s": baseline_s,
            "resume_s": resumed_s, "resume_puts": resume_puts,
            "shards_skipped": mgr.stats["shards_skipped"],
            "degraded_shard_reads": mgr.stats["degraded_shard_reads"],
            "restore_s": restore_s}


def _live_copies(block: dict, dead) -> bool:
    """A replicated block keeps a live replica; an EC block keeps ``k``
    live shards."""
    alive = [a for a in block["locations"] if a and a not in dead]
    k = int(block.get("ec_data_shards") or 0)
    return len(alive) >= k if k else bool(alive)


def tearing_victim(metas: dict, ec: tuple[int, int], chunkservers) -> str:
    """The chunkserver whose death tears an RS(``ec``) put that starts
    now, read from the metadata of the files a save has landed (``{path:
    get_file_info}``): one that holds a shard of every landed EC block
    (the placement put it in each, and puts it in the next one until the
    master drops it), whose loss leaves every landed block a live copy
    and at least ``k + m`` others of the live ``chunkservers``
    (addresses) to place the resumed put on. Raises RuntimeError when no
    chunkserver qualifies."""
    blocks = [b for meta in metas.values() for b in meta["blocks"]]
    servers = set(chunkservers)
    ec_blocks = [b for b in blocks if int(b.get("ec_data_shards") or 0)]
    if not ec_blocks:
        raise RuntimeError("no landed EC block to read a victim from")
    common = set.intersection(*(set(b["locations"]) for b in ec_blocks))
    for victim in sorted(common - {""}):
        if len(servers - {victim}) >= sum(ec) and all(
                _live_copies(b, {victim}) for b in blocks):
            return victim
    raise RuntimeError(
        f"no chunkserver tears an RS{tuple(ec)} put and leaves every "
        f"landed block a live copy: every EC block holds {sorted(common)}, "
        f"{len(servers)} chunkservers live")


async def kills_tear_checkpoint(client, kill, chunkservers, *, base: str,
                                kib: int, reader, device=None,
                                ec: tuple[int, int] = (2, 1),
                                resume_s: float = 90.0) -> dict:
    """A save that the kills alone tear: the variant of
    :func:`kill_mid_checkpoint` whose saver is never cancelled.

    A 2-shard checkpoint (hot 3x copy and an RS(``ec``) cold copy) saves
    step 1, then step 2's shard 0. The victim is read from the save's own
    metadata (:func:`tearing_victim`, ``chunkservers`` the live ones'
    addresses): a chunkserver holding a shard of every landed EC block,
    whose loss leaves every block of step 1 and of shard 0 a live copy.
    Shard 1's hot copy lands; as its cold copy's put begins,
    ``kill([victim])`` (sync or async, addresses) SIGKILLs it. The master
    places the put on the victim until its liveness cutoff drops it, so
    the put fails by itself and the save with it (``interrupted``; the
    save is awaited in place, never a task that anything could cancel).
    Step 2 must then not be listed. The save is
    resumed until it publishes, within ``resume_s`` (past the master's
    cutoff): no payload of shard 0, whose ETags match, may be put again.
    The namespace must list exactly [1, 2], and both steps restore
    bit-exact through ``reader`` into ``device`` (``cuda:0`` by default).

    Returns the victim, the blocks it left live, how the save ended (its
    error), what was listed while torn, the resume's seconds and payload
    puts a shard, the manager's ``shards_skipped`` and
    ``degraded_shard_reads``, and each step's restore seconds."""
    device = resolve_device(device)
    log = PutLog(client)
    mgr = CheckpointManager(log, base, num_shards=2, ec=ec, reader=reader)
    trees = {s: _trees(s, kib) for s in (1, 2)}
    payloads = {
        (step, s): [ckptpaths.shard_data_path(base, step, s),
                    ckptpaths.shard_ec_path(base, step, s)]
        for step, s in ((1, 0), (1, 1), (2, 0), (2, 1))}
    t0 = time.perf_counter()
    await mgr.save(1, trees[1])
    baseline_s = time.perf_counter() - t0
    await mgr.save_shard(2, 0, trees[2][0])
    landed = [p for key in ((1, 0), (1, 1), (2, 0)) for p in payloads[key]]
    metas = {p: await client.get_file_info(p) for p in landed}
    victim = tearing_victim(metas, ec, chunkservers)
    kills = []

    async def kill_victim() -> None:
        kills.append(time.perf_counter())
        await _call(kill, [victim])

    log.before[payloads[2, 1][1]] = kill_victim

    async def save_rest() -> None:
        await mgr.save_shard(2, 1, trees[2][1])
        await mgr.commit(2)

    t0 = time.perf_counter()
    try:
        await save_rest()
        error = None
    except Exception as e:
        if not (is_fault(e) or isinstance(e, IncompleteCheckpointError)):
            raise
        error = f"{type(e).__name__}: {str(e)[:200]}"
    torn_s = time.perf_counter() - t0
    if not kills:
        raise AssertionError("the save never began shard 1's cold copy")
    if error is None:
        raise AssertionError(f"the save outlived the kill of {victim}: "
                             "nothing was torn")
    listed_torn = await mgr.list_steps()
    if listed_torn != [1]:
        raise AssertionError(f"while step 2 was torn the namespace listed "
                             f"{listed_torn}")
    puts_before = len(log.calls)
    resumed_s = await retry_until("step-2 resume",
                                  lambda: mgr.save(2, trees[2]), resume_s)
    resume_puts = {s: sum(log.calls[puts_before:].count(p)
                          for p in payloads[2, s]) for s in (0, 1)}
    if resume_puts[0]:
        raise AssertionError(
            f"the resume put shard 0 again ({resume_puts[0]}x) although it "
            "had landed before the kill")
    steps = await mgr.list_steps()
    if steps != [1, 2]:
        raise AssertionError(
            f"namespace lists {steps}, want [1, 2]: a torn or missing "
            "checkpoint is visible")
    restore_s = {s: (await restore_checked(mgr, s, kib, device))["seconds"]
                 for s in steps}
    return {"victim": victim, "blocks_kept_live": sum(
                len(m["blocks"]) for m in metas.values()),
            "interrupted": error is not None, "error": error,
            "torn_s": torn_s, "listed_torn": listed_torn,
            "baseline_s": baseline_s, "resume_s": resumed_s,
            "resume_puts": resume_puts,
            "shards_skipped": mgr.stats["shards_skipped"],
            "degraded_shard_reads": mgr.stats["degraded_shard_reads"],
            "restore_s": restore_s}


# ----------------------------------------------------- the roulette's axis


def roulette_manager(client, *, reader):
    """The checkpoint axis's manager: 2 shards, the hot 3x copy plus an
    RS(2,1) cold copy."""
    return CheckpointManager(client, "/a/roulette-ckpt", num_shards=2,
                             ec=(2, 1), reader=reader)


class MasterKill(NamedTuple):
    """A plan's master kill: one member of ``shard``'s Raft group, its
    leader when ``leader`` is set, else a member that does not lead; which
    one is decided when the kill is injected."""

    shard: str
    leader: bool


class Partition(NamedTuple):
    """A plan's partition: ``shard``'s leader (as it stands when the plan
    starts) cut off from the client that routes to it through a proxy,
    for ``duration`` seconds, then healed."""

    shard: str
    duration: float


def kill_plan(rng: random.Random, names, *, shards: dict | None = None,
              first: tuple = (1.0, 3.0), gap: tuple = (1.0, 3.0)) -> list:
    """A seeded, survivable plan of faults, ``[(offset_s, victim), ...]``,
    with offsets from the plan's start drawn as the roulette draws them
    (``first``, then ``gap`` apart).

    Without ``shards``: one or two chunkserver kills of ``names`` (RS(2,1)
    still places on three of five). With ``shards`` (``{shard_id:
    [master addresses]}``): the roulette's ``make_plan``
    (``scripts/chaos_roulette.py``), draw for draw: two to four faults,
    each a :class:`Partition` of a shard (``uniform(1.5, 4.0)`` seconds), a
    chunkserver kill while fewer than two were drawn, or a
    :class:`MasterKill` of a shard not drawn yet, its leader with
    probability 0.7, the shard drawn in ``shards``' own order. One
    difference keeps quorum: a shard whose group has fewer than 3 masters
    is never a kill victim here (the reference's plan may kill it); with
    every group at 3 or more, the same seed and endpoints give the
    reference's plan."""
    names = sorted(names)
    plan, t = [], rng.uniform(*first)
    if shards is None:
        for _ in range(rng.randint(1, 2)):
            victim = rng.choice(names)
            names.remove(victim)
            plan.append((t, victim))
            t += rng.uniform(*gap)
        return plan
    killed: set[str] = set()
    cs_kills = 0
    for _ in range(rng.randint(2, 4)):
        groups = [s for s in shards
                  if s not in killed and len(shards[s]) >= 3]
        kinds = ["partition"] + (["cs"] if cs_kills < 2 and names else []) \
            + (["master"] if groups else [])
        kind = rng.choice(kinds)
        if kind == "cs":
            victim = rng.choice(names)
            names.remove(victim)
            cs_kills += 1
        elif kind == "master":
            shard = rng.choice(groups)
            killed.add(shard)
            victim = MasterKill(shard, rng.random() < 0.7)
        else:
            victim = Partition(rng.choice(sorted(shards)),
                               rng.uniform(1.5, 4.0))
        plan.append((t, victim))
        t += rng.uniform(*gap)
    return plan


async def run_kill_plan(plan, kill, kill_master=None,
                        partition=None) -> list[dict]:
    """Inject ``plan``'s faults at their offsets: ``kill(victim)`` for a
    chunkserver, ``kill_master(shard, leader)`` for a :class:`MasterKill`
    (it returns what it killed, or None when it skipped: no leader while
    an election runs), ``partition(shard, duration)`` for a
    :class:`Partition` (it partitions, heals after ``duration`` and
    returns what it cut off, or None when it skipped; the plan waits for
    it, as the roulette's injector waits out each partition). Returns
    each fault's offset, victim and outcome."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    done = []
    for offset, victim in plan:
        wait = offset - (loop.time() - t0)
        if wait > 0:
            await asyncio.sleep(wait)
        if isinstance(victim, MasterKill):
            if kill_master is None:
                raise ValueError("the plan holds a master kill and no "
                                 "kill_master was given")
            out = await _call(kill_master, victim.shard, victim.leader)
            done.append({"offset": offset, "shard": victim.shard,
                         "leader": victim.leader, "killed": out})
            logger.info("+%.1fs master of %s (leader=%s): %s", offset,
                        victim.shard, victim.leader, out or "skipped")
        elif isinstance(victim, Partition):
            if partition is None:
                raise ValueError("the plan holds a partition and no "
                                 "partition was given")
            out = await _call(partition, victim.shard, victim.duration)
            done.append({"offset": offset, "shard": victim.shard,
                         "duration": victim.duration, "partitioned": out})
            logger.info("+%.1fs partition of %s for %.1fs: %s", offset,
                        victim.shard, victim.duration, out or "skipped")
        else:
            await _call(kill, victim)
            done.append({"offset": offset, "killed": victim})
            logger.info("+%.1fs killed %s", offset, victim)
    return done


async def save_through_faults(mgr, *, steps: int, rng: random.Random,
                              kib: int, faults) -> tuple[int, set[int]]:
    """Sequential saves of steps 1..``steps`` through the fault window (the
    roulette's checkpointer). ``faults()``, a coroutine function such as a
    kill plan's run, starts once the first step is acked, so that at least
    one step is published before anything dies, and is awaited before
    this returns. An interrupted save is logged, never fatal: whether its
    commit landed is decided after the faults, from what the namespace
    lists. Returns (last step attempted, steps acked)."""
    attempted, published, injector = 0, set(), None
    try:
        for step in range(1, steps + 1):
            attempted = step
            try:
                await mgr.save(step, _trees(step, kib, mgr.num_shards))
                published.add(step)
                logger.info("step %d published", step)
                if injector is None:
                    injector = asyncio.ensure_future(faults())
            except Exception as e:
                if not is_fault(e):
                    raise
                logger.info("step %d save interrupted (%s)", step,
                            type(e).__name__)
            await asyncio.sleep(rng.uniform(0.2, 0.8))
    except BaseException:
        if injector is not None:
            injector.cancel()
        raise
    if injector is not None:
        await injector
    return attempted, published


async def _settle(what: str, op, settle_s: float):
    """The roulette's settling discipline: availability errors
    (``IndeterminateError``) retry once a second for ``settle_s``;
    anything else fails at once."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + settle_s
    while True:
        try:
            return await op()
        except Exception as e:
            if not is_error_named(e, "IndeterminateError"):
                raise
            if loop.time() > deadline:
                raise RuntimeError(
                    f"{what} failed {settle_s} s after the faults: {e}") \
                    from e
            await asyncio.sleep(1.0)


async def settle_and_verify(mgr, attempted: int, published: set, *,
                            kib: int, device=None,
                            settle_s: float = 45.0) -> dict:
    """The roulette's post-fault check: every acked step is listed; the
    last attempted step, when unlisted, is resumed (content-ETag skips,
    then the commit) and listed; every listed step restores bit-exact
    into ``device`` (``cuda:0`` by default) through the manager's
    reader."""
    device = resolve_device(device)
    listed = await _settle("ckpt list", mgr.list_steps, settle_s)
    # The loop's acks are a lower bound: a commit whose ack was lost to a
    # kill still published. The namespace is authoritative.
    if not set(published) <= set(listed):
        raise AssertionError(
            f"acked steps {sorted(published)} missing from listed {listed}")
    resume = attempted if attempted > max(listed, default=0) else 0
    if resume:
        trees = _trees(resume, kib, mgr.num_shards)
        await _settle(f"ckpt resume step {resume}",
                      lambda: mgr.save(resume, trees), settle_s)
        listed = await _settle("ckpt relist", mgr.list_steps, settle_s)
        if resume not in listed:
            raise AssertionError(f"resumed step {resume} not listed")
    if not listed:
        raise AssertionError("no step published or resumable")
    restore_s = {}
    for s in listed:
        restore_s[s] = (await _settle(
            f"ckpt restore step {s}",
            lambda s=s: restore_checked(mgr, s, kib, device),
            settle_s))["seconds"]
    return {"listed": listed, "acked": sorted(published),
            "resumed": resume or None,
            "shards_skipped": mgr.stats["shards_skipped"],
            "degraded_shard_reads": mgr.stats["degraded_shard_reads"],
            "restore_s": restore_s}


# ------------------------------------------- an RS rebuild after the kills


def data_shard_holders(metas) -> collections.Counter:
    """How many data shards (code-word index < k) each chunkserver holds
    over the EC blocks of ``metas`` (file metadata as ``get_file_info``
    returns it)."""
    held = collections.Counter()
    for meta in metas:
        for block in meta["blocks"]:
            k = int(block.get("ec_data_shards") or 0)
            held.update(a for a in block["locations"][:k] if a)
    return held


def data_shard_victims(metas, n: int = 2) -> tuple[list, int, dict]:
    """The ``n`` chunkservers that hold the most data shards over the EC
    blocks of ``metas`` (ties by address), how many of those blocks have
    a data shard on one of them (each must be rebuilt once they die), and
    every holder's count."""
    held = data_shard_holders(metas)
    victims = sorted(held, key=lambda a: (-held[a], a))[:n]
    lost = sum(1 for meta in metas for block in meta["blocks"]
               if set(block["locations"][:int(block["ec_data_shards"])])
               & set(victims))
    return victims, lost, dict(held)


async def rebuild_after_kills(client, kill, *, base: str, kib: int, reader,
                              device=None) -> dict:
    """Save an EC-only RS(3,2) checkpoint of 2 shards, kill the two
    chunkservers that hold the most data shards (``kill(victims)``, a list
    of addresses), then restore it through ``reader`` into ``device``
    (``cuda:0`` by default), bit-exact. Every block that lost a data shard
    must be rebuilt by the GF(2^8) decode (the kernel on a card, its
    plain twin on the CPU): raises unless the reader rebuilt exactly the
    blocks that lost one, and, on a card, unless the kernel launched at
    least once for each.

    Returns ``blocks_lost_data`` (blocks with a data shard on a victim),
    ``gf256_launches`` (kernel launches during the restore; 0 on the CPU),
    ``rebuilt_blocks`` (the reader's device rebuilds), the victims and the
    restore's seconds. The client must not read the victims' disks behind
    their backs (the reference client's local short circuit would)."""
    device = resolve_device(device)
    mgr = CheckpointManager(client, base, num_shards=2, ec=(3, 2),
                            hot_copies=False, reader=reader)
    manifest = await mgr.save(1, _trees(1, kib))
    metas = [await client.get_file_info(s["ec_path"])
             for s in manifest["shards"]]
    victims, lost, held = data_shard_victims(metas)
    await _call(kill, victims)
    launches, rebuilt = gf_matmul_words.launches, reader.ec_rebuilds
    restore_s = (await restore_checked(mgr, 1, kib, device))["seconds"]
    launches = gf_matmul_words.launches - launches
    rebuilt = reader.ec_rebuilds - rebuilt
    if rebuilt != lost:
        raise AssertionError(
            f"{lost} blocks lost a data shard and {rebuilt} were rebuilt")
    if device.type == "cuda" and launches < lost:
        raise AssertionError(
            f"{lost} blocks lost a data shard and the GF(2^8) kernel "
            f"launched {launches} times")
    return {"blocks_lost_data": lost, "gf256_launches": launches,
            "rebuilt_blocks": rebuilt, "victims": victims,
            "data_shards_held": held, "restore_s": restore_s}
