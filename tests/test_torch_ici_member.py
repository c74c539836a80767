"""The member half of the collective write group's protocol:
``tpudfs_torch.chunkserver.ici_member.try_ici_write`` against the
reference's ``ChunkServer._try_ici_write``, and what ``attach`` installs.

- Hook parity: both bodies run on the same stand-in member and a stub
  group whose ``Error`` is the reference's ``IciWriteError`` (the class the
  reference catches), one case per branch; return value, fallback count,
  cache invalidations and the submission must agree.
- ``IciWriteGroup.attach`` binds the port's hook on the member, and a
  write through it rides a collective round on CPU positions.
- The live collective-write leg (``graft_entry.live_collective_write``
  with the port's default group on the reference ``InprocCluster``) in an
  interpreter that cannot import JAX: the reference chunkserver's own hook
  imports the JAX package, so before the port bound its copy every
  collective write failed there."""

import asyncio
import re
import types

import numpy as np
import pytest
import torch

from tpudfs.chunkserver.service import ChunkServer
from tpudfs.tpu.write_group import IciWriteError
from tpudfs_torch.chunkserver import ici_member
from tpudfs_torch.gpu.ici_replication import make_mesh
from tpudfs_torch.gpu.write_group import IciWriteGroup
from torch_nojax import run_without_jax

CPU = torch.device("cpu")
RING = ["cs0:1", "cs1:1", "cs2:1"]
REQ = {"master_term": "7", "master_shard": "shard-a"}


class StubGroup:
    """A write group's surface as the hook sees it; ``submit`` records its
    arguments and then raises ``raises`` or returns 3."""

    Error = IciWriteError
    replication = 3

    def __init__(self, healthy=True, raises=None):
        self._healthy = healthy
        self.raises = raises
        self.submits = []

    def healthy(self) -> bool:
        return self._healthy

    def successors(self, position: int) -> list[str]:
        return [RING[(position + j) % 3] for j in (1, 2)]

    async def submit(self, position, block_id, data, master_term,
                     master_shard) -> int:
        self.submits.append((position, block_id, len(data), master_term,
                             master_shard))
        if self.raises is not None:
            raise self.raises
        return 3


class StandIn:
    """A member: what ``ChunkServer._try_ici_write`` reads off ``self``."""

    def __init__(self, group, address="cs0:1", position=0):
        self.address = address
        self._ici_group = group
        self._ici_pos = position
        self.ici_fallbacks = 0
        self.invalidated = []

    def invalidate_cached(self, block_id: str) -> None:
        self.invalidated.append(block_id)


CASES = {
    # name: (group kwargs, chain, expected result, fallbacks, submitted)
    "short_chain": ({}, ["cs1:1"], None, 0, False),
    "unhealthy": ({"healthy": False}, RING[1:], None, 1, False),
    "wrong_successors": ({}, ["cs2:1", "cs1:1"], None, 1, False),
    "group_error": ({"raises": IciWriteError("round verified on 2/3")},
                    RING[1:], None, 1, True),
    "success": ({}, RING[1:], {"success": True, "error_message": "",
                               "replicas_written": 3}, 0, True),
}


def _run(hook, case: str) -> tuple:
    kwargs, chain, *_ = CASES[case]
    group = StubGroup(**kwargs)
    member = StandIn(group)
    out = asyncio.run(hook(member, "blk_1", b"x" * 1000, dict(REQ), chain))
    return out, member.ici_fallbacks, member.invalidated, group.submits


@pytest.mark.parametrize("case", list(CASES))
def test_hook_matches_reference_on_every_branch(case):
    got = _run(ici_member.try_ici_write, case)
    want = _run(ChunkServer._try_ici_write, case)
    assert got == want
    _, _, result, fallbacks, submitted = CASES[case]
    out, n_fallbacks, invalidated, submits = got
    assert out == result and n_fallbacks == fallbacks
    assert invalidated == (["blk_1"] if result else [])
    assert submits == ([(0, "blk_1", 1000, 7, "shard-a")] if submitted
                       else [])


def test_hook_propagates_other_errors_as_reference():
    for hook in (ici_member.try_ici_write, ChunkServer._try_ici_write):
        group = StubGroup(raises=RuntimeError("not the group's error"))
        member = StandIn(group)
        with pytest.raises(RuntimeError, match="not the group's error"):
            asyncio.run(hook(member, "blk_1", b"x", {}, RING[1:]))
        assert member.ici_fallbacks == 0 and member.invalidated == []
        assert group.submits == [(0, "blk_1", 1, 0, "")]


class Member(StandIn):
    """A stand-in member that persists into a dict."""

    def __init__(self, address):
        super().__init__(None, address)
        self.persisted = {}

    async def persist_ici_replica(self, block_id, data, master_term,
                                  master_shard) -> bool:
        self.persisted[block_id] = bytes(data)
        return True


def test_attach_binds_the_ports_hook_and_a_write_rides_a_round():
    members = [Member(a) for a in RING]
    group = IciWriteGroup(make_mesh([CPU] * 3), RING, replication=3)
    for i, m in enumerate(members):
        group.attach(m, i)
        assert isinstance(m._try_ici_write, types.MethodType)
        assert m._try_ici_write.__func__ is ici_member.try_ici_write
        assert m._try_ici_write.__self__ is m
    data = np.random.default_rng(3).integers(0, 256, 5000,
                                             dtype=np.uint8).tobytes()

    async def write():
        try:
            return await members[1]._try_ici_write(
                "blk_a", data, {"master_term": 1, "master_shard": "s"},
                group.successors(1))
        finally:
            await group.stop()

    out = asyncio.run(write())
    assert out == {"success": True, "error_message": "",
                   "replicas_written": 3}
    assert group.stats.rounds == 1 and members[1].invalidated == ["blk_a"]
    assert all(m.persisted == {"blk_a": data} for m in members)
    group.detach(2)
    assert members[2]._ici_group is None and not group.healthy()


def test_live_collective_write_runs_without_jax():
    """The live leg with the port's default group on the reference
    InprocCluster, in an interpreter that refuses ``jax``."""
    r = run_without_jax('''
        import torch
        from tpudfs.testing.inproc import InprocCluster
        from tpudfs_torch.graft_entry import live_collective_write
        msg = live_collective_write([torch.device("cpu")] * 4,
                                    cluster_factory=InprocCluster)
        result = {"msg": msg}
    ''', timeout=180)
    assert r["loaded_jax"] == []
    msg = r["msg"]
    rounds, blocks = map(int, re.search(
        r"(\d+) collective round\(s\)/(\d+) blocks on a 4-CS ring",
        msg).groups())
    assert rounds >= 1 and blocks >= 2
    assert "master failover -> 127.0.0.1:" in msg
    assert "garbage member EC(2,2) gather reconstructed" in msg
    assert "3 puts during failover" in msg
    assert int(re.search(r"\((\d+) fallback\(s\)\)", msg).group(1)) >= 1
