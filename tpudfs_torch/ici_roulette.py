"""Randomized soak of the collective write group — counterpart of
``scripts/ici_roulette.py``.

Each round boots a FRESH in-process cluster (1 master, 3 chunkservers)
whose chunkservers form the port's :class:`IciWriteGroup` on three
positions, runs concurrent client puts, and injects the group's failure
modes WHILE writes are in flight:

- ``detach``: a member leaves the group mid-stream (group unhealthy ->
  writes degrade to the TCP chain) and re-attaches later;
- ``device_fail``: the replicate call raises for a window (round
  failures -> per-write TCP fallback);
- ``verify_fail``: the replicate call returns zero acks for a window (the
  round must fail ATOMICALLY — no partial persists).

Each injection waits for rounds to flow, then holds its fault until it
bites: a fallback counted (``detach``) or a round failed. Once the writers
are done, the injector puts files itself while it holds one.

Checks per round: every acked put reads back byte-exact through a fresh
client; no block of a failed round is on any member's disk when the round
fails; the group re-heals, and a final put rides a collective round again
(recovery, not just degradation). A failed check raises AssertionError.

The port cannot build a cluster (the reference's ``InprocCluster`` is the
one it is tested on), so there is no command line: the caller passes
``cluster_factory(workdir, n_masters, n_cs)``, as to
``graft_entry.live_collective_write``, and ``tests/test_torch_ici_roulette.py``
is the runner.
"""

from __future__ import annotations

import asyncio
import random
import tempfile

from tpudfs_torch.gpu.ici_replication import make_mesh
from tpudfs_torch.gpu.write_group import IciWriteGroup
from tpudfs_torch.graft_entry import _check

N_CS = 3
WRITERS = 4
FILES_PER_WRITER = 6
FILE_BYTES = 96 * 1024  # multi-block at 64 KiB blocks
BLOCK_SIZE = 64 * 1024
KINDS = ("detach", "device_fail", "verify_fail")
#: The longest a fault is held waiting to bite (seconds).
HOLD_S = 30.0


async def _round(devices, cluster_factory, rnd: int, rng: random.Random,
                 seed: int, plan) -> dict:
    with tempfile.TemporaryDirectory(prefix="tpudfs-icirl-") as wd:
        c = cluster_factory(wd, 1, N_CS)
        await c.start()
        group = IciWriteGroup(make_mesh(list(devices[:N_CS])),
                              [cs.address for cs in c.chunkservers],
                              replication=3)
        for i, cs in enumerate(c.chunkservers):
            cs.attach_ici_group(group, i)
        try:
            await c.ready()
            client = c.client(block_size=BLOCK_SIZE)

            # Fault plan: 1-3 injections, ACTIVITY-triggered — each waits
            # for collective rounds to flow before striking, so a loaded
            # host cannot make every window miss the write stream.
            real_replicate = group.replicator.replicate
            if plan is None:
                plan = [rng.choice(KINDS) for _ in range(rng.randint(1, 3))]
            bites = [False] * len(plan)  # per WINDOW, not per kind
            done = asyncio.Event()

            # A failed round must persist nothing: when the group fails a
            # round's blocks, none of them may be on any member's disk (the
            # TCP fallback that follows writes them later). Checked after
            # the writers: raising here would strand the round's writers.
            real_fail = group._fail_round
            failed_blocks: set[str] = set()
            stored: list[str] = []

            def fail_round(per_pos, msg: str) -> None:
                ids = {p.block_id for take in per_pos for p in take
                       if not p.fut.done()}
                stored.extend(bid for bid in ids for cs in c.chunkservers
                              if cs.store.exists(bid))
                failed_blocks.update(ids)
                real_fail(per_pos, msg)

            group._fail_round = fail_round

            def attempts() -> int:
                return group.stats.rounds + group.stats.round_failures

            def fallbacks() -> int:
                return sum(cs.ici_fallbacks for cs in c.chunkservers)

            async def wait_for_activity(baseline: int) -> None:
                while attempts() <= baseline and not done.is_set():
                    await asyncio.sleep(0.02)

            written: dict[str, bytes] = {}
            # The injector's own puts, made while a fault is held after the
            # writers finished; one stream, drawn by the injector alone.
            held_rng = random.Random((seed << 8) ^ (rnd << 4) ^ 0xF)

            async def put(path: str, rng_: random.Random, size: int):
                data = rng_.getrandbits(8 * size).to_bytes(size, "little")
                await client.create_file(path, data)
                written[path] = data

            async def hold_until_bite(probe, w_i: int) -> bool:
                """Keep the fault in place until ``probe()`` shows it BIT,
                or ``HOLD_S`` passed. Once the writers finished, the
                injector puts files itself, so the fault meets traffic
                however slowly the host ran the writers."""
                loop = asyncio.get_running_loop()
                deadline = loop.time() + HOLD_S
                n = 0
                while not probe() and loop.time() < deadline:
                    if done.is_set():
                        await put(f"/icirl/held{w_i}/f{n}", held_rng,
                                  BLOCK_SIZE)
                        n += 1
                    else:
                        await asyncio.sleep(0.05)
                # Let an in-flight round resolve against the fault.
                await asyncio.sleep(0.1)
                return probe()

            def boom(*a, **k):
                raise RuntimeError("injected device failure")

            def short(words, crcs):
                replicas, ok, acks = real_replicate(words, crcs)
                return replicas, ok, acks * 0  # zero acks

            async def injector():
                for w_i, kind in enumerate(plan):
                    await wait_for_activity(attempts())
                    if done.is_set():
                        return
                    mark, fb = group.stats.round_failures, fallbacks()
                    if kind == "detach":
                        pos = rng.randrange(N_CS)
                        group.detach(pos)
                        bites[w_i] = await hold_until_bite(
                            lambda: fallbacks() > fb, w_i)
                        group.attach(c.chunkservers[pos], pos)
                    else:
                        group.replicator.replicate = (
                            boom if kind == "device_fail" else short)
                        bites[w_i] = await hold_until_bite(
                            lambda: group.stats.round_failures > mark, w_i)
                        group.replicator.replicate = real_replicate

            async def writer(w: int):
                # A child RNG per writer: concurrent coroutines drawing from
                # one stream would make the content depend on interleaving.
                wrng = random.Random((seed << 8) ^ (rnd << 4) ^ w)
                for i in range(FILES_PER_WRITER):
                    await put(f"/icirl/w{w}/f{i}", wrng, FILE_BYTES)
                    await asyncio.sleep(wrng.uniform(0.0, 0.15))

            async def all_writers():
                try:
                    await asyncio.gather(*(writer(w) for w in range(WRITERS)))
                finally:
                    done.set()

            await asyncio.gather(injector(), all_writers())
            _check(not stored, f"round {rnd}: a failed round persisted "
                   f"{sorted(set(stored))}; plan {plan}")

            # Every acked write reads back byte-exact via a FRESH client.
            v = c.client(block_size=BLOCK_SIZE)
            for path, data in written.items():
                _check(await v.get_file(path) == data,
                       f"round {rnd}: {path} corrupt; plan {plan}")

            # Recovery: with the group healthy again, a final put must ride
            # a collective round (not be stuck on TCP forever).
            _check(group.healthy(), f"round {rnd}: group never re-healed")
            before = group.stats.rounds
            await client.create_file("/icirl/final", rng.getrandbits(
                8 * BLOCK_SIZE).to_bytes(BLOCK_SIZE, "little"))
            _check(group.stats.rounds > before,
                   f"round {rnd}: post-fault put did not ride a round")
            return {"round": rnd, "plan": list(plan),
                    "bit": [k for k, b in zip(plan, bites) if b],
                    "missed": [k for k, b in zip(plan, bites) if not b],
                    "puts_checked": len(written),
                    "rounds": group.stats.rounds,
                    "blocks": group.stats.blocks,
                    "round_failures": group.stats.round_failures,
                    "failed_blocks": len(failed_blocks),
                    "fallbacks": fallbacks()}
        finally:
            await group.stop()
            await c.stop()


def run_round(devices, cluster_factory, rnd: int, rng: random.Random,
              seed: int, *, plan=None) -> dict:
    """One soak round on the first three of ``devices`` (ring positions).
    ``plan`` forces the injections (a list of :data:`KINDS`); by default
    1-3 are drawn from ``rng``. Returns the round's plan, which injections
    ``bit`` and which ``missed``, the puts checked, the group's
    ``rounds``, ``blocks`` and ``round_failures``, the blocks of failed
    rounds (``failed_blocks``) and the members' ``fallbacks``."""
    return asyncio.run(_round(devices, cluster_factory, rnd, rng, seed, plan))


def roulette(devices, cluster_factory, rounds: int = 5,
             seed: int = 42) -> list[dict]:
    """``rounds`` soak rounds, each with its own RNG, so a failed round
    replays from its own seed without replaying the ones before it."""
    return [run_round(devices, cluster_factory, rnd,
                      random.Random((seed << 16) ^ rnd), seed)
            for rnd in range(1, rounds + 1)]
