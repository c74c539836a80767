"""Entry points of the port — counterpart of ``__graft_entry__.py``.

- :func:`entry`: the single-device "forward step" of the data path, the
  device half of a ChunkServer WriteBlock: per-512-byte-chunk CRC32C of a
  chunk batch, RS(6,3) parity of the same bytes, and a 3-deep replicated
  write step on a 1-position ring (every hop lands on the sender, so the
  whole hop + verify + ack step runs on one device).
- :func:`dryrun_multichip`: the whole distributed data-plane step over n
  ring positions: replicated write with RS(6,3) parity, an RS(k,m) shard
  scatter and a degraded gather around a garbage position, and the same
  collectives on a 2-D ``(dcn, ici)`` pod mesh; optionally the live
  collective write path under composed faults (:func:`live_collective_write`).

A position is not a device (``gpu/ici_replication.py``): with fewer cards
than positions every position lives on one card, which is the port's
counterpart of the reference's virtual CPU mesh. There is no CPU fallback:
without a card the entry points raise, unless the caller passes
``torch.device("cpu")``. Every step runs eagerly.

    python -m tpudfs_torch.graft_entry      # on a CUDA card
"""

from __future__ import annotations

import asyncio
import tempfile
import time

import numpy as np
import torch

from tpudfs_torch.common import native
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c_chunks
from tpudfs_torch.gpu import host_to_device, resolve_device
from tpudfs_torch.gpu.crc32c_cuda import (
    WORDS_PER_CHUNK,
    bytes_to_words,
    crc32c_blocks_device,
    crc32c_chunks_device,
)
from tpudfs_torch.gpu.ici_replication import (
    EcShardGather,
    EcShardScatter,
    IciReplicator,
    Mesh,
    _i32,
    make_mesh,
    replicated_write_step,
)
from tpudfs_torch.gpu.rs_cuda import (
    gf_matmul_words,
    pad_shard_len,
    rs_encode_device,
)
from tpudfs_torch.gpu.write_group import IciWriteGroup

#: The entry step's code and the dryrun write step's parity.
EC = (6, 3)
#: Word value written over the failed position's shards in the degraded
#: gather (the reference writes 0xAB into every uint32 of them).
GARBAGE = 0xAB


def positions(n: int, device=None) -> list[torch.device]:
    """n ring positions: one card each when there are at least n cards,
    else all n on ``resolve_device(device)`` (``None``: ``cuda:0``; raises
    without a card unless ``device`` is the CPU)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def sync(*devices: torch.device) -> None:
    """Wait for the work queued on each distinct card of ``devices``."""
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count (a wrapper counts a launch only
    where it launches its kernel on a card)."""
    return {"crc32c_chunks": crc32c_chunks_device.launches,
            "crc32c_blocks": crc32c_blocks_device.launches,
            "gf256_matmul": gf_matmul_words.launches}


def device_words(rng, shape, device) -> torch.Tensor:
    """Random uint32 words made on ``device``, from a torch generator seeded
    by the numpy generator ``rng`` (no host copy, so grids of a GiB take
    milliseconds)."""
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 62)))
    return torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                         device=device, generator=gen).view(torch.uint32)


# ------------------------------------------------------------------ entry


def entry(device=None, *, chunks: int = 96):
    """The single-device write step and its example arguments.

    Returns ``(step, (words, expected_crcs))``: ``step(words,
    expected_crcs)`` takes (chunks, 128) uint32 words and their (chunks,)
    uint32 CRCs on ``device`` and returns ``crc_ok`` (0-d bool),
    ``chunk_crcs`` ((chunks,) uint32), ``parity`` ((3, chunks*512/6) uint8,
    RS(6,3) of the words' bytes split into 6 shards), ``write_acks`` (0-d
    int32) and ``write_ok`` (0-d bool). The example words are
    ``chunks * 512`` bytes from ``np.random.default_rng(0)``, as the
    reference makes them. Raises ValueError when the bytes do not split into
    6 shards of a 128-byte multiple (the GF kernel's row width)."""
    device = resolve_device(device)
    k, m = EC
    total = chunks * CHECKSUM_CHUNK_SIZE
    shard, rest = divmod(total, k)
    if chunks < 1 or rest or pad_shard_len(shard) != shard:
        raise ValueError(f"{chunks} chunks do not split into {k} shards of a "
                         f"multiple of 128 bytes")
    wstep = replicated_write_step(make_mesh([device]), replication=3)

    def step(words: torch.Tensor, expected_crcs: torch.Tensor) -> dict:
        actual = crc32c_chunks_device(words)
        ok = (_i32(actual) == _i32(expected_crcs)).all()
        parity = rs_encode_device(_i32(words).view(torch.uint8).reshape(k, -1),
                                  k, m)
        wout = wstep([words], [expected_crcs])
        return {"crc_ok": ok, "chunk_crcs": actual, "parity": parity,
                "write_acks": wout["acks"],
                "write_ok": torch.cat(wout["ok"]).all()}

    data = np.random.default_rng(0).integers(0, 256, total, dtype=np.uint8) \
        .tobytes()
    example = (host_to_device(bytes_to_words(data), device),
               host_to_device(crc32c_chunks(data).astype(np.uint32), device))
    return step, example


# ----------------------------------------------------------------- dryrun


def ec_geometry(n: int) -> tuple[int, int]:
    """RS(k, m) of the dryrun's scatter on n positions: one shard a
    position, RS(6,3) from 9 positions, the widest full-parity code below
    that; m = 0 means no scatter (2 positions)."""
    if n >= 9:
        return 6, 3
    if n >= 6:
        return n - 3, 3
    if n >= 4:
        return n - 2, 2
    k = min(2, n)
    return k, (1 if n >= k + 1 or n == 1 else 0)


def pod_geometry(n: int) -> tuple[int, int, int, int, int] | None:
    """(dcn, ici, replication, k, m) of the 2-D pod leg: the smallest factor
    >= 2 of n that leaves a ring of >= 2 is the dcn extent; the chain and
    an RS(k, m) scatter as wide as the ring ride the ici axis. None when n
    has no such factorization (a prime)."""
    n_dcn = next((f for f in range(2, n + 1) if n % f == 0 and n // f >= 2),
                 None)
    if n_dcn is None:
        return None
    n_ici = n // n_dcn
    k = max(1, n_ici - 2)
    return n_dcn, n_ici, min(3, n_ici), k, n_ici - k


def dryrun_inputs(devices, chunks_per_position: int, seed: int):
    """Per position, (C, 128) uint32 words made on its device from
    ``seed``, and their (C,) expected chunk CRCs, computed on the host by
    the native CRC (independent of the kernel that verifies them)."""
    rng = np.random.default_rng(seed)
    words, crcs = [], []
    for d in devices:
        w = device_words(rng, (chunks_per_position, WORDS_PER_CHUNK), d)
        crc = native.crc32c_chunks(_i32(w).cpu().numpy().view(np.uint8))
        words.append(w)
        crcs.append(host_to_device(crc.astype(np.uint32), d))
    return words, crcs


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _verified(ok: list[torch.Tensor], acks: torch.Tensor, n: int,
              what: str) -> None:
    acks = int(acks)
    _check(acks == n and all(bool(o) for o in ok),
           f"{what}: {acks}/{n} positions verified")


def write_leg(mesh: Mesh, words, crcs, replication: int) -> dict:
    """``replicated_write_step(mesh, replication, ec=(6, 3))``, checked:
    every position acked, every replica verified, ``n * replication``
    replica groups, parity made."""
    n = len(words)
    out = replicated_write_step(mesh, replication, ec=EC)(words, crcs)
    _verified(out["ok"], out["acks"], n, "replicated write")
    _check(sum(r.shape[0] for r in out["replicas"]) == n * replication,
           "replica groups do not sum to positions x replication")
    _check(out["parity"][0].shape[-1] > 0, "no parity")
    return out


def reconstructed(recon: torch.Tensor, words: torch.Tensor) -> bool:
    """The first len(words) bytes of the (k, S, 128) data shards are the
    position's words, compared on its device."""
    n = words.numel()
    return torch.equal(_i32(recon).reshape(-1)[:n], _i32(words).reshape(-1))


def ec_leg(mesh: Mesh, words, k: int, m: int) -> dict:
    """RS(k, m) scatter, then the degraded gather with ring position 0's
    shards garbage (``None`` on a 1-position mesh), checked: every shard
    verified, every position's words reconstructed bit-exact. Returns the
    scatter's ``shards``, ``ok`` and ``acks``, the ``broken`` shards the
    gather got, ``failed`` and ``recon``."""
    n = len(words)
    shards, ok, acks = EcShardScatter(mesh, k, m).scatter(words)
    _verified(ok, acks, n, f"EC({k},{m}) shard scatter")
    failed = 0 if n > 1 else None
    broken = list(shards)
    if failed is not None:
        broken[failed] = torch.full_like(_i32(shards[failed]), GARBAGE) \
            .view(torch.uint32)
    recon = EcShardGather(mesh, k, m).gather(broken, failed=failed)
    bad = [p for p in range(n) if not reconstructed(recon[p], words[p])]
    _check(not bad, f"degraded EC gather mismatch on positions {bad}")
    return {"shards": shards, "ok": ok, "acks": acks, "broken": broken,
            "failed": failed, "recon": recon}


def pod_leg(devices, words, crcs, geometry) -> dict:
    """The chain and an RS(k, m) scatter on the 2-D ``(dcn, ici)`` mesh of
    ``geometry`` (:func:`pod_geometry`), both riding the ici axis, checked
    as the 1-D legs are. The per-position lists keep their flat order."""
    n_dcn, n_ici, rep, k, m = geometry
    mesh = Mesh(np.array(devices, dtype=object).reshape(n_dcn, n_ici),
                ("dcn", "ici"))
    replicas, ok, acks = IciReplicator(mesh, rep, axis="ici").replicate(
        words, crcs)
    _verified(ok, acks, len(words), "2-D pod chain")
    shards, sok, sacks = EcShardScatter(mesh, k, m, axis="ici").scatter(words)
    _verified(sok, sacks, len(words), "2-D pod EC scatter")
    return {"replicas": replicas, "ok": ok, "acks": acks, "shards": shards,
            "scatter_ok": sok, "scatter_acks": sacks}


def dryrun_body(devices, *, chunks_per_position: int = 6, seed: int = 1,
                live=None) -> dict:
    """The multi-position step on ``devices`` (one per position; a device
    may repeat), each leg checked as the reference checks it (a failed
    check raises AssertionError). ``live``: None, or a callable that runs
    the live collective-write leg on the devices and returns its message,
    e.g. ``functools.partial(live_collective_write,
    cluster_factory=InprocCluster)``. Prints the reference's
    ``dryrun_multichip OK: ...`` line and returns what was verified, with
    each leg's host-clock seconds (ended by a synchronize) and kernel
    launches, and the launches of the whole run. Each leg, its closing
    synchronize included, is a ``dryrun.<leg>`` profiler range, so a
    trace of the run shows which device work belongs to which leg."""
    devices = list(devices)
    n = len(devices)
    mesh = make_mesh(devices)
    replication = min(3, n)
    k, m = ec_geometry(n)
    pod = pod_geometry(n)
    seconds, leg_launches = {}, {}

    def leg(name, fn):
        sync(*devices)
        before = launch_counts()
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"dryrun.{name}"):
            out = fn()
            sync(*devices)
        seconds[name] = time.perf_counter() - t0
        leg_launches[name] = {key: v - before[key]
                              for key, v in launch_counts().items()}
        return out

    words, crcs = leg("inputs", lambda: dryrun_inputs(
        devices, chunks_per_position, seed))
    out = leg("write", lambda: write_leg(mesh, words, crcs, replication))
    acks = int(out["acks"])
    parity_shape = list(out["parity"][0].shape)
    del out
    result = {"positions": n, "devices": [str(d) for d in devices],
              "chunks_per_position": chunks_per_position, "seed": seed,
              "replication": replication, "write_acks": acks,
              "replica_groups": n * replication, "parity": list(EC),
              "parity_shape": parity_shape, "ec": None, "pod": None}
    ec_msg = "EC shard scatter skipped (mesh too small)"
    if m:
        ec = leg("scatter_gather", lambda: ec_leg(mesh, words, k, m))
        result.update(ec=[k, m], scatter_acks=int(ec["acks"]),
                      gather_failed=ec["failed"],
                      shard_bytes=ec["shards"][0].shape[1]
                      * CHECKSUM_CHUNK_SIZE,
                      exact=True)
        del ec
        ec_msg = (f"EC({k},{m}) shard scatter verified + degraded gather "
                  f"reconstructed around position {result['gather_failed']}")
    pod_msg = (f"pod 2-D leg skipped ({n} positions have no (dcn>=2, "
               f"ici>=2) factorization)")
    if pod is not None:
        p = leg("pod", lambda: pod_leg(devices, words, crcs, pod))
        n_dcn, n_ici, rep2, k2, m2 = pod
        result["pod"] = {"shape": [n_dcn, n_ici], "replication": rep2,
                         "ec": [k2, m2], "acks": int(p["acks"]),
                         "scatter_acks": int(p["scatter_acks"]),
                         "shard_bytes": p["shards"][0].shape[1]
                         * CHECKSUM_CHUNK_SIZE}
        del p
        pod_msg = (f"pod {n_dcn}x{n_ici} (dcn,ici) chain x{rep2} + "
                   f"EC({k2},{m2}) scatter verified")
    del words, crcs
    result["live"] = None
    if live is not None:
        result["live"] = leg("live", lambda: live(devices))
    live_msg = result["live"] or "live collective write not run"
    result.update(seconds=seconds, leg_launches=leg_launches, launches={
        key: sum(c[key] for c in leg_launches.values())
        for key in launch_counts()})
    result["message"] = (
        f"dryrun_multichip OK: {n}-position mesh, {replication}x chain "
        f"replication, on-device CRC verified, RS(6,3) parity encoded, "
        f"{ec_msg}, {pod_msg}, {live_msg}, EC width on this mesh: "
        f"k+m<={n} (RS(6,3) needs >=9 positions), acks={acks}")
    print(result["message"], flush=True)
    return result


def dryrun_multichip(n: int, device=None, *, chunks_per_position: int = 6,
                     live=None) -> dict:
    """:func:`dryrun_body` on ``positions(n, device)``: one card a position
    when there are n cards, else all n positions on one device."""
    return dryrun_body(positions(n, device),
                       chunks_per_position=chunks_per_position, live=live)


# ------------------------------------------------------- live write path


def live_collective_write(devices, cluster_factory, *,
                          group_cls=IciWriteGroup) -> str:
    """A live in-process cluster whose chunkservers form a collective write
    group on the first ``min(4, n)`` positions: a client put must ride
    collective rounds; then a master failover, three puts and an EC
    scatter + degraded gather around a garbage member (in a thread) run
    concurrently, and every put reads back; then a dead member's put must
    take the TCP chain (a fallback counted, no new round).

    ``cluster_factory(workdir, n_masters, n_cs)`` returns a cluster with
    ``start``, ``ready``, ``leader``, ``client``, ``chunkservers``,
    ``masters``, ``heartbeats`` and ``stop`` (``InprocCluster``'s surface);
    ``group_cls`` is the write group its chunkservers attach. ``attach``
    binds the port's own ``_try_ici_write`` on each chunkserver, so the
    leg needs no JAX on the host. Returns the leg's message; a failed check
    raises AssertionError."""
    n_ring = min(4, len(devices))
    if n_ring < 3:
        return "live collective write skipped (mesh < 3 positions)"
    ring = list(devices[:n_ring])
    mesh = make_mesh(ring)
    block = 64 * 1024

    def rand(n: int, seed: int) -> bytes:
        return np.random.default_rng(seed).integers(
            0, 256, n, dtype=np.uint8).tobytes()

    def gather_with_garbage() -> tuple[int, int]:
        # EC scatter + degraded gather around a garbage member, on the
        # positions the write group uses.
        k, m = n_ring - 2, 2
        words = bytes_to_words(rand(n_ring * 6 * CHECKSUM_CHUNK_SIZE, 9))
        parts = [host_to_device(np.array(w), d)
                 for w, d in zip(np.split(words, n_ring), ring)]
        ec_leg(mesh, parts, k, m)
        return k, m

    async def run() -> str:
        with tempfile.TemporaryDirectory(prefix="tpudfs-dryrun-") as wd:
            c = cluster_factory(wd, 3, n_ring)
            await c.start()
            group = group_cls(mesh, [cs.address for cs in c.chunkservers],
                              replication=3)
            try:
                for i, cs in enumerate(c.chunkservers):
                    cs.attach_ici_group(group, i)
                await c.ready()
                client = c.client(block_size=block)
                data = rand(2 * block, 7)
                await client.create_file("/dryrun/a", data)
                _check(group.stats.rounds >= 1, "no collective round ran")
                _check(await client.get_file("/dryrun/a") == data,
                       "/dryrun/a reads back wrong")

                # ---- composed faults, concurrently ----
                leader = await c.leader()

                async def new_leader():
                    while True:
                        for mst in c.masters.values():
                            if mst is not leader and mst.raft.is_leader:
                                return mst
                        await asyncio.sleep(0.05)

                async def failover() -> str:
                    await leader.stop()
                    return (await asyncio.wait_for(new_leader(), 20.0)).address

                async def puts_during_failover() -> list:
                    out = []
                    for i in range(3):
                        d = rand(block, 20 + i)
                        await client.create_file(f"/dryrun/f{i}", d)
                        out.append((f"/dryrun/f{i}", d))
                    return out

                fail_task = asyncio.ensure_future(failover())
                puts_task = asyncio.ensure_future(puts_during_failover())
                try:
                    k, m = await asyncio.to_thread(gather_with_garbage)
                finally:
                    new_leader_addr = await fail_task
                    written = await puts_task
                for path, d in written:
                    _check(await client.get_file(path) == d,
                           f"{path} reads back wrong")

                # ---- dead member degrades to the TCP chain ----
                rounds_before = group.stats.rounds
                await c.chunkservers[-1].stop()
                c.heartbeats[-1].stop()
                d = rand(block, 31)
                await client.create_file("/dryrun/tcp", d)
                _check(group.stats.rounds == rounds_before,
                       "collective round ran with a dead member")
                _check(await client.get_file("/dryrun/tcp") == d,
                       "/dryrun/tcp reads back wrong")
                fallbacks = sum(cs.ici_fallbacks for cs in c.chunkservers)
                _check(fallbacks >= 1, "the dead member's put did not fall "
                       "back to the TCP chain")
                return (
                    f"live collective write: {group.stats.rounds} collective "
                    f"round(s)/{group.stats.blocks} blocks on a {n_ring}-CS "
                    f"ring; composed faults OK (master failover -> "
                    f"{new_leader_addr}, garbage member EC({k},{m}) gather "
                    f"reconstructed, {len(written)} puts during failover); "
                    f"dead member degraded to TCP ({fallbacks} fallback(s))")
            finally:
                await group.stop()
                await c.stop()

    return asyncio.run(run())


# ------------------------------------------------------------------- main


def main() -> None:
    step, args = entry()
    out = step(*args)
    _check(bool(out["write_ok"]) and int(out["write_acks"]) == 1,
           f"entry write step: ok {bool(out['write_ok'])}, acks "
           f"{int(out['write_acks'])}")
    print("entry OK:", bool(out["crc_ok"]), tuple(out["parity"].shape),
          "write_acks:", int(out["write_acks"]), flush=True)
    n_real = torch.cuda.device_count()
    if 2 <= n_real != 8:
        # Every card its own position, including >= 9 cards, where the
        # dryrun runs RS(6,3) with one shard a card.
        dryrun_multichip(n_real)
    dryrun_multichip(8)
    dryrun_multichip(9)


if __name__ == "__main__":
    main()
