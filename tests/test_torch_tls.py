"""TLS through the port: its test PKI (``tpudfs_torch.pki``), its gRPC
channels (``tpudfs_torch.common.rpc``), its blockport pool
(``tpudfs_torch.common.blocknet``) and its client against the reference's
TLS servers, in process; then, in an interpreter that refuses ``jax`` and
loads no ``tpudfs`` module, a ``TopologyCluster`` of
``deploy/topologies/two-shard.json`` with TLS on every transport (the
system's servers as processes). Byte functions: no tolerance."""

from __future__ import annotations

import asyncio
from pathlib import Path

import numpy as np
import pytest

from tests.test_master_service import FAST_RAFT, _free_port
from tpudfs.chunkserver.blockstore import BlockStore
from tpudfs.chunkserver.heartbeat import HeartbeatLoop
from tpudfs.chunkserver.service import ChunkServer
from tpudfs.common import native as ref_native
from tpudfs.common.rpc import RpcClient as RefRpcClient
from tpudfs.common.rpc import RpcServer, ServerTls
from tpudfs.master.service import Master
from tpudfs_torch.client.client import Client
from tpudfs_torch.common.blocknet import BlockConnPool
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.common.rpc import ClientTls, RpcClient, RpcError
from tpudfs_torch.pki import make_test_pki
from torch_nojax import run_without_jax

REPO = Path(__file__).resolve().parents[1]
CS = "ChunkServerService"


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    return make_test_pki(tmp_path_factory.mktemp("pki"))


def _rand(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


async def _echo_server(tls: ServerTls) -> tuple[RpcServer, str]:
    server = RpcServer(port=0, tls=tls)

    async def echo(req):
        return {"echo": req["x"]}

    server.add_service("T", {"Echo": echo})
    return server, f"127.0.0.1:{await server.start()}"


async def _refused(client: RpcClient, addr: str) -> None:
    try:
        with pytest.raises(RpcError):
            await client.call(addr, "T", "Echo", {"x": 1}, timeout=3.0)
    finally:
        await client.close()


async def test_reference_server_accepts_the_ports_pki(pki, tmp_path):
    """The port's PKI serves the reference's TLS server: the port's channel
    trusting its CA round-trips; a plaintext channel and one trusting
    another CA are refused; the PKI's files are the reference's set."""
    assert sorted(pki) == ["ca", "client_cert", "client_key", "server_cert",
                           "server_key"]
    server, addr = await _echo_server(ServerTls(pki["server_cert"],
                                                pki["server_key"]))
    try:
        await _refused(RpcClient(), addr)
        other = make_test_pki(tmp_path / "other")
        await _refused(RpcClient(tls=ClientTls(ca_path=other["ca"])), addr)
        good = RpcClient(tls=ClientTls(ca_path=pki["ca"]))
        assert await good.call(addr, "T", "Echo", {"x": 42},
                               timeout=5.0) == {"echo": 42}
        await good.close()
    finally:
        await server.stop()


async def test_mtls_requires_the_clients_certificate(pki):
    server, addr = await _echo_server(ServerTls(
        pki["server_cert"], pki["server_key"], ca_path=pki["ca"]))
    try:
        await _refused(RpcClient(tls=ClientTls(ca_path=pki["ca"])), addr)
        mutual = RpcClient(tls=ClientTls(ca_path=pki["ca"],
                                         cert_path=pki["client_cert"],
                                         key_path=pki["client_key"]))
        assert await mutual.call(addr, "T", "Echo", {"x": 7},
                                 timeout=5.0) == {"echo": 7}
        await mutual.close()
    finally:
        await server.stop()


async def _tls_cluster(pki, tmp_path, n_cs: int = 3):
    """A reference master and ``n_cs`` chunkservers (the native blockport
    engine), every listener and peer channel under TLS; out of safe mode."""
    rpc = RefRpcClient(tls=ClientTls(ca_path=pki["ca"]))
    stls = ServerTls(pki["server_cert"], pki["server_key"])
    addr = f"127.0.0.1:{_free_port()}"
    m = Master(addr, [], str(tmp_path / "m"), raft_timings=FAST_RAFT,
               rpc_client=rpc)
    server = RpcServer(port=int(addr.rsplit(":", 1)[1]), tls=stls)
    m.attach(server)
    await server.start()
    await m.start()
    parts = {"rpc": rpc, "master": m, "server": server, "addr": addr,
             "chunkservers": [], "heartbeats": []}
    for i in range(n_cs):
        cs = ChunkServer(BlockStore(tmp_path / f"cs{i}/hot"), rack_id=f"r{i}",
                         master_addrs=[addr], rpc_client=rpc)
        await cs.start(scrubber=False, tls=stls)
        hb = HeartbeatLoop(cs, [addr], interval=0.3)
        hb.start()
        parts["chunkservers"].append(cs)
        parts["heartbeats"].append(hb)
    for _ in range(100):
        if m.raft.is_leader and not m.state.safe_mode:
            break
        if m.state.safe_mode and m.state.should_exit_safe_mode():
            m.state.exit_safe_mode()
        await asyncio.sleep(0.05)
    return parts


async def _stop(parts) -> None:
    for hb in parts["heartbeats"]:
        hb.stop()
    for cs in parts["chunkservers"]:
        await cs.stop()
    await parts["master"].stop()
    await parts["server"].stop()
    await parts["rpc"].close()


async def test_port_client_writes_and_reads_over_tls(pki, tmp_path):
    """The port's client with ``ClientTls`` writes a 3x and an RS(2,1) file
    through the native engines' TLS blockports and reads both back; a
    plaintext port client cannot reach the cluster."""
    if not ref_native.has_dataplane():
        pytest.skip("the servers' native data plane is unavailable")
    parts = await _tls_cluster(pki, tmp_path)
    client = Client([parts["addr"]], tls=ClientTls(ca_path=pki["ca"]),
                    block_size=65536, local_reads=False)
    plain = Client([parts["addr"]], max_retries=0, rpc_timeout=3.0)
    try:
        files = {"/tls/rep": (_rand(200_003, 1), None),
                 "/tls/ec": (_rand(150_001, 2), (2, 1))}
        for path, (data, ec) in files.items():
            await client.create_file(path, data, ec=ec)
        for path, (data, _ec) in files.items():
            assert await client.get_file(path) == data
            assert await client.read_file_range(path, 65_535, 3) \
                == data[65_535:65_538]
        assert all(cs._native_dp is not None and cs.data_port > 0
                   for cs in parts["chunkservers"])
        assert sum(cs.data_plane_stats()["forwards"]
                   for cs in parts["chunkservers"]) >= 1
        with pytest.raises(Exception):
            await plain.get_file("/tls/rep")
    finally:
        await client.close()
        await plain.close()
        await _stop(parts)


async def test_port_blockport_reads_the_native_tls_blockport(pki, tmp_path):
    """The port's ``BlockConnPool`` under TLS sends a 3x chain through the
    native engines' TLS blockports and reads each replica back from them;
    a plaintext pool gets no blockport answer."""
    if not ref_native.has_dataplane():
        pytest.skip("the servers' native data plane is unavailable")
    parts = await _tls_cluster(pki, tmp_path)
    tls = ClientTls(ca_path=pki["ca"])
    rpc = RpcClient(tls=tls)
    pool = BlockConnPool(tls=tls)
    try:
        data = _rand(300_000, 3)
        head, mid, tail = (cs.address for cs in parts["chunkservers"])
        ports = await pool.data_ports(rpc, [head, mid, tail], CS)
        assert all(p > 0 for p in ports)
        resp = await pool.call(rpc, head, CS, "WriteBlock", {
            "block_id": "tlsport", "data": data,
            "next_servers": [mid, tail], "next_data_ports": ports[1:],
            "expected_crc32c": crc32c(data), "master_term": 0})
        assert resp["success"] and resp["replicas_written"] == 3
        for addr in (head, mid, tail):
            back = await pool.call(rpc, addr, CS, "ReadBlock", {
                "block_id": "tlsport", "offset": 0, "length": 0})
            assert bytes(back["data"]) == data
        assert parts["chunkservers"][0].data_plane_stats()["forwards"] >= 1
        plain_rpc, plain_pool = RpcClient(), BlockConnPool()
        try:
            assert await plain_pool.data_ports(plain_rpc, [head], CS) == [0]
        finally:
            await plain_rpc.close()
    finally:
        await rpc.close()
        await _stop(parts)


def test_topology_cluster_over_tls_without_jax_or_tpudfs(tmp_path):
    """In a fresh interpreter that refuses ``jax``: ``TopologyCluster`` on
    ``deploy/topologies/two-shard.json`` with TLS (a config server, two
    1-master shards, 4 chunkservers); the port's client writes a file on
    each shard, reads both back and lists them across the shards; then
    one shard's master is SIGKILLed (``kill_master``) and the other shard
    still writes. No ``tpudfs`` or ``jax`` module is loaded."""
    r = run_without_jax(f"""
        import asyncio, os, sys
        from pathlib import Path
        from tpudfs_torch.client.client import Client
        from tpudfs_torch.cluster import TopologyCluster, find_leader

        topo = Path({str(REPO)!r}) / "deploy/topologies/two-shard.json"
        data = {{"/a/low": os.urandom(200_003), "/z/high": os.urandom(70_001)}}

        async def run(cluster):
            client = Client(cluster.all_masters,
                            config_addrs=[cluster.config_addr],
                            tls=cluster.client_tls, block_size=65536,
                            local_reads=False)
            try:
                out = {{}}
                for path, blob in data.items():
                    await client.create_file(path, blob)
                out["owners"] = sorted({{client.shard_map.get_shard(p)
                                        for p in data}})
                out["read"] = all([await client.get_file(p) == blob
                                   for p, blob in data.items()])
                out["listed"] = await client.list_files("/")
                out["native"] = [
                    (await client.rpc.call(cs.addr, "ChunkServerService",
                                           "DataPort", {{}}))["native"]
                    for cs in cluster.chunkservers]
                victim_shard = client.shard_map.get_shard("/z/high")
                out["killed"] = await cluster.kill_master(victim_shard)
                await client.create_file("/a/after", b"still here")
                out["after"] = await client.get_file("/a/after")
                return out
            finally:
                await client.close()

        with TopologyCluster(Path({str(tmp_path)!r}), topo, tls=True) \\
                as cluster:
            leaders = {{sid: find_leader(addrs, tls=cluster.client_tls)
                        for sid, addrs in cluster.shards.items()}}
            result = asyncio.run(run(cluster))
            result["after"] = result["after"].decode()
            result["leaders"] = leaders
            result["shards"] = cluster.shards
            result["servers"] = len(cluster.procs)
            result["alive"] = sum(p.poll() is None for p in cluster.procs)
            result["tls"] = cluster.client_tls is not None
        result["dead_after"] = sum(p.poll() is None for p in cluster.procs)
        result["tpudfs"] = sorted(m for m in sys.modules
                                  if m == "tpudfs" or m.startswith("tpudfs."))
    """, timeout=60)
    assert r["loaded_jax"] == [] and r["tpudfs"] == []
    assert r["tls"] and r["read"] and r["after"] == "still here"
    assert r["owners"] == ["shard-0", "shard-z"]
    assert r["listed"] == ["/a/low", "/z/high"]
    assert r["native"] == [True] * 4
    assert {sid: [a] for sid, a in r["leaders"].items()} == r["shards"]
    name, addr = r["killed"]
    assert addr == r["leaders"]["shard-0"] and name == "shard-0-m0"
    # 1 config server + 2 masters + 4 chunkservers; one master killed.
    assert (r["servers"], r["alive"], r["dead_after"]) == (7, 6, 0)
