"""``test_torch_client.py::test_leader_failover_follows_hints`` repeated,
with the port's client or the reference's as the writer, both reading back;
on a wrong read it reports the metadata the file had before the leader
stopped and after, and each master's view before the stop: the Raft log's
entries for the file (index, term, op), its ``last_applied`` and the
blocks its state lists. Not part of the suite (the name does not match
``test_*``); run it by path, several at a time:

    JAX_PLATFORMS=cpu TORCH_FAILOVER_RUNS=100 python -m pytest \\
        tests/torch_failover_repeat.py -q -p xdist -n 6
"""

from __future__ import annotations

import json
import os

import pytest

from tests.test_torch_client import _cluster, _rand, _stop

RUNS = int(os.environ.get("TORCH_FAILOVER_RUNS", "50"))


def _views(c, path: str) -> dict:
    out = {}
    for addr, m in c.masters.items():
        f = m.state.files.get(path)
        out[addr] = {
            "log": [(e.index, e.term, e.command.get("op"))
                    for e in m.raft.core.log
                    if isinstance(e.command, dict)
                    and e.command.get("path") == path],
            "last_applied": m.raft.core.last_applied,
            "blocks": None if f is None else len(f.blocks),
            "leader": m.raft.is_leader}
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("run", range(RUNS))
async def test_failover_read_back(tmp_path, run, writer):
    c, port, ref = await _cluster(tmp_path, n_cs=3, n_masters=3)
    w = port if writer == "port" else ref
    try:
        leader = await c.leader()
        w.master_addrs = [a for a in c.masters if a != leader.address] \
            + [leader.address]
        before = _rand(100_000, 6)
        await w.create_file("/ha/before", before)
        meta_before = await port.get_file_info("/ha/before")
        views = _views(c, "/ha/before")
        await leader.stop()
        await c.servers[leader.address].stop()
        del c.masters[leader.address]
        await c.wait_out_of_safe_mode(await c.leader(timeout=15.0))
        after = _rand(150_000, 7)
        await w.create_file("/ha/after", after)
        wrong = []
        for name, cl in (("port", port), ("ref", ref)):
            try:
                got = await cl.get_file("/ha/before")
            except Exception as e:
                got = e
            if got != before:
                wrong.append({
                    "reader": name,
                    "got": repr(got)[:200] if isinstance(got, Exception)
                    else f"{len(got)} bytes",
                    "meta_before": meta_before,
                    "meta_now": await cl.get_file_info("/ha/before"),
                    "masters_before_the_stop": views})
        assert not wrong, json.dumps(wrong, default=str)
    finally:
        await _stop(c, port)
