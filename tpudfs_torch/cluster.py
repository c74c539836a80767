"""Cluster launcher: the system's master and chunkservers as OS processes,
for the port's bench and smoke — the port's own copy of
``tpudfs/testing/procs.py`` (``free_port``, ``spawn``, ``wait_ready``,
``terminate_all``) and of the JAX bench's ``_spawn_cluster``
(``bench.py:265-312``).

    with ProcessCluster(root, n_cs=5) as cluster:
        client = Client([cluster.master_addr], ...)

The servers are started by module name (``python3 -m tpudfs.master``,
``python3 -m tpudfs.chunkserver``) with the JAX bench's flags: one rack per
chunkserver, 0.5 s heartbeats, the scrubber held off for an hour, the ops
HTTP endpoint off. They are the system's own processes; this process talks
to them over the wire only and imports none of their code. Each child dies
with this process (``PR_SET_PDEATHSIG``), and the launcher stops every
process it started on exit and on failure.

Readiness: each server prints ``READY <addr>`` once its sockets are bound.
A chunkserver first builds the system's native library when it is missing
(about 13 s of g++), so the first one is started alone and the others
together once it is ready. A server that exits before it is ready fails
the start, with its log's tail in the error. The cluster is ready
once the master places an RS(n_cs - 1, 1) probe file on every chunkserver,
which it does only when all of them are registered and it has left safe
mode.

The system's own deployment is :class:`TopologyCluster`, the port's copy
of ``scripts/start_cluster.py``: a config server, one master Raft group
a shard and the chunkservers of a ``deploy/topologies/*.json`` spec,
with TLS on every transport when asked. Leader discovery
(:func:`find_leader`, :func:`find_leader_async`) asks each master for its
Raft state over the wire (the client's ``raft_state``).

    with TopologyCluster(root, REPO / "deploy/topologies/two-shard-ha.json",
                         tls=True) as cluster:
        client = Client(cluster.all_masters,
                        config_addrs=[cluster.config_addr],
                        tls=cluster.client_tls)

The Helm chart's deployment (``deploy/helm/tpudfs``) is
:class:`HelmCluster`: three config servers in one Raft group, each
bootstrap shard's masters as one Raft group, spare groups that
hot-prefix splits take (one each), and chunkservers that find the
masters through the config group's map. :func:`find_config_leader` and
:meth:`HelmCluster.kill_config` find and kill the config group's leader;
:func:`wait_moved` and :func:`wait_redirect` wait out a split.

    with HelmCluster(root) as cluster:
        client = cluster.client()  # the config servers alone
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

#: Seconds a server may take to print READY (a chunkserver may compile the
#: native library first).
READY_TIMEOUT_S = 300.0
#: Seconds the master may take to register every chunkserver.
REGISTER_TIMEOUT_S = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Bound at import: preexec_fn runs between fork and exec, where imports or
# dlopen in a multithreaded parent can deadlock the child.
try:
    import ctypes as _ctypes

    _PRCTL = _ctypes.CDLL(None).prctl
except (OSError, AttributeError):
    _PRCTL = None


def _die_with_parent() -> None:
    """PR_SET_PDEATHSIG: the kernel SIGTERMs the child when its parent
    dies, so a killed run leaves no orphaned servers behind."""
    if _PRCTL is not None:
        _PRCTL(1, 15)  # PR_SET_PDEATHSIG=1, SIGTERM=15


def spawn(procs: list[subprocess.Popen], name: str, logdir: Path, mod: str,
          *args: str, env: dict | None = None) -> subprocess.Popen:
    """Start ``python -m mod`` appended to ``procs``, stdout and stderr to
    ``logdir/name.log``."""
    with open(logdir / f"{name}.log", "w") as log:
        p = subprocess.Popen(
            [sys.executable, "-m", mod, *args],
            env={**os.environ, "PYTHONPATH": str(REPO), **(env or {})},
            stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=_die_with_parent,
        )
    procs.append(p)
    return p


def wait_ready(logdir: Path, name: str, proc: subprocess.Popen | None = None,
               timeout: float = READY_TIMEOUT_S) -> str:
    """Until ``name``'s log holds its READY line; returns the address it
    printed. Raises RuntimeError when ``proc`` exits first or the timeout
    passes."""
    deadline = time.time() + timeout
    path = logdir / f"{name}.log"
    while time.time() < deadline:
        text = path.read_text() if path.exists() else ""
        if "READY " in text:
            return text.split("READY ", 1)[1].split()[0]
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"{name} exited with {proc.returncode} before "
                               f"it was ready:\n{text[-3000:]}")
        time.sleep(0.1)
    raise RuntimeError(f"{name} failed to start in {timeout:.0f} s; see {path}")


def terminate_all(procs: list[subprocess.Popen], grace: float = 5.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.time() + grace
    for p in procs:
        while p.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        if p.poll() is None:
            p.kill()
            p.wait()


@dataclass
class ServerProc:
    name: str
    proc: subprocess.Popen
    addr: str

    def kill(self) -> None:
        """SIGKILL, and reap."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)


@dataclass
class ChunkServerProc(ServerProc):
    data_dir: Path


class ProcessCluster:
    """1 master and ``n_cs`` chunkservers under ``root`` (data dirs ``m0``,
    ``cs<i>``; logs in ``logs/``). ``cache_blocks`` sets each
    chunkserver's ``BLOCK_CACHE_SIZE`` (the servers' default when None).
    :meth:`start` runs its own event loop: call it outside one."""

    def __init__(self, root: str | Path, n_cs: int = 3, *,
                 cache_blocks: int | None = None):
        if n_cs < 2:
            raise ValueError("n_cs must be >= 2")
        self.root = Path(root)
        self.n_cs = n_cs
        self.cache_blocks = cache_blocks
        self.procs: list[subprocess.Popen] = []
        self.master_addr = ""
        self.chunkservers: list[ChunkServerProc] = []
        #: Wall seconds of :meth:`start`: spawns, READY lines, registration.
        self.start_s = 0.0

    def start(self) -> "ProcessCluster":
        t0 = time.perf_counter()
        logdir = self.root / "logs"
        logdir.mkdir(parents=True, exist_ok=True)
        try:
            port = free_port()
            m = spawn(self.procs, "master", logdir, "tpudfs.master",
                      "--port", str(port), "--data-dir", str(self.root / "m0"),
                      "--http-port", "0")
            self.master_addr = wait_ready(logdir, "master", m)
            cs_env = {}
            if self.cache_blocks is not None:
                cs_env["BLOCK_CACHE_SIZE"] = str(self.cache_blocks)
            started = []
            for i in range(self.n_cs):
                name, data_dir = f"cs{i}", self.root / f"cs{i}"
                # Port 0: the chunkserver binds an ephemeral port and
                # prints it (no window for another process to take it).
                p = spawn(self.procs, name, logdir, "tpudfs.chunkserver",
                          "--port", "0",
                          "--data-dir", str(data_dir),
                          "--masters", self.master_addr,
                          "--rack-id", f"rack-{i}",
                          "--heartbeat-interval", "0.5",
                          "--scrub-interval", "3600",
                          "--http-port", "0", env=cs_env)
                started.append((name, p, data_dir))
                if i == 0:
                    # The first one builds the native library if it is
                    # missing; the others start together once it is ready.
                    wait_ready(logdir, name, p)
            for name, p, data_dir in started:
                self.chunkservers.append(ChunkServerProc(
                    name, p, wait_ready(logdir, name, p), data_dir))
            asyncio.run(self._wait_registered())
        except BaseException:
            self.stop()
            raise
        self.start_s = time.perf_counter() - t0
        return self

    async def _wait_registered(self) -> None:
        """Until the master places an RS(n_cs - 1, 1) probe, i.e. has left
        safe mode with every chunkserver registered."""
        from tpudfs_torch.client.client import Client

        client = Client([self.master_addr], max_retries=0, local_reads=False)
        deadline = time.monotonic() + REGISTER_TIMEOUT_S
        try:
            while True:
                self._check_alive()
                try:
                    await client.create_file("/.cluster-ready", b"ready",
                                             ec=(self.n_cs - 1, 1),
                                             overwrite=True)
                    await client.delete_file("/.cluster-ready")
                    return
                except Exception as e:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"the master did not register {self.n_cs} "
                            f"chunkservers in {REGISTER_TIMEOUT_S:.0f} s: "
                            f"{e}") from None
                    await asyncio.sleep(0.2)
        finally:
            await client.close()

    def _check_alive(self) -> None:
        for name, p in zip(["master"] + [c.name for c in self.chunkservers],
                           self.procs):
            if p.poll() is not None:
                raise RuntimeError(f"{name} exited with {p.returncode}; see "
                                   f"{self.root / 'logs' / (name + '.log')}")

    def stop(self) -> None:
        terminate_all(self.procs)

    def __enter__(self) -> "ProcessCluster":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------ leader discovery


async def _leader_async(addrs, state, timeout: float) -> str | None:
    """The address among ``addrs`` whose ``await state(addr)`` (a Raft
    status) says ``role == "leader"``; ``None`` after ``timeout``."""
    deadline = time.monotonic() + timeout
    while True:
        for addr in addrs:
            try:
                status = await state(addr)
            except Exception:
                continue  # dead or unreachable: not the leader
            if status.get("role") == "leader":
                return addr
        if time.monotonic() >= deadline:
            return None
        await asyncio.sleep(0.3)


async def find_leader_async(addrs, *, tls=None, client=None,
                            timeout: float = 20.0) -> str | None:
    """The address among ``addrs`` whose master says it leads, asked with
    the client's ``raft_state`` (``client``, or one made here with
    ``tls``); ``None`` when none does within ``timeout`` seconds (an
    election is still running: the caller skips its action instead of
    failing). Never blocks the event loop."""
    own = client is None
    if own:
        from tpudfs_torch.client.client import Client

        client = Client(list(addrs), tls=tls, max_retries=0,
                        local_reads=False)
    try:
        return await _leader_async(addrs, client.raft_state, timeout)
    finally:
        if own:
            await client.close()


def find_leader(addrs, *, tls=None, timeout: float = 30.0) -> str:
    """Blocking leader discovery: call it outside a running event loop.
    Raises RuntimeError when no master of ``addrs`` leads within
    ``timeout`` seconds."""
    addr = asyncio.run(find_leader_async(addrs, tls=tls, timeout=timeout))
    if addr is None:
        raise RuntimeError(f"no leader among {list(addrs)} in {timeout} s")
    return addr


async def find_config_leader_async(addrs, *, tls=None,
                                   timeout: float = 20.0) -> str | None:
    """The config server among ``addrs`` that says it leads its Raft group
    (``ConfigService.RaftState``), or ``None`` when none does within
    ``timeout`` seconds."""
    from tpudfs_torch.common.rpc import RpcClient

    rpc = RpcClient(tls=tls)

    def state(addr):
        return rpc.call(addr, "ConfigService", "RaftState", {}, timeout=2.0)

    try:
        return await _leader_async(addrs, state, timeout)
    finally:
        await rpc.close()


def find_config_leader(addrs, *, tls=None, timeout: float = 30.0) -> str:
    """Blocking :func:`find_config_leader_async`: call it outside a running
    event loop. Raises RuntimeError when no config server leads."""
    addr = asyncio.run(find_config_leader_async(addrs, tls=tls,
                                                timeout=timeout))
    if addr is None:
        raise RuntimeError(f"no config leader among {list(addrs)} in "
                           f"{timeout} s")
    return addr


async def wait_moved(client, path: str, source: str,
                     timeout: float) -> float:
    """Until the config group's map (fetched through ``client``) gives
    ``path`` to a shard other than ``source``, as a split that carves
    ``path``'s range off does; the seconds it took. Raises RuntimeError
    after ``timeout`` seconds."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if await client.refresh_shard_map() and \
                client.shard_map.get_shard(path) != source:
            return time.perf_counter() - t0
        await asyncio.sleep(0.25)
    raise RuntimeError(f"{path} still on {source} after {timeout} s")


async def wait_redirect(client, addrs, path: str, target: str,
                        timeout: float = 60.0) -> float:
    """Until the leader of ``addrs`` (a split's source shard) answers
    ``GetFileInfo`` of ``path`` with ``REDIRECT:<target>``: it serves the
    moved range from its own frozen copy until it has handed the metadata
    over, a tick after the map moved (a follower checks ownership against
    its own map before it refuses as a follower, and may redirect
    earlier). The seconds it took; RuntimeError after ``timeout``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        leader = await find_leader_async(addrs, client=client, timeout=2.0)
        try:
            if leader is not None:
                await client.rpc.call(leader, "MasterService",
                                      "GetFileInfo", {"path": path},
                                      timeout=2.0)
        except Exception as e:
            if getattr(e, "redirect_hint", None) == target:
                return time.perf_counter() - t0
        await asyncio.sleep(0.25)
    raise RuntimeError(f"the leader of {addrs} still serves {path} "
                       f"{timeout} s after the map moved it to {target}")


def probe_paths(shard_map) -> dict[str, str]:
    """A path inside each shard's key range of a range ``shard_map``
    (``{shard_id: path}``), read from the map's own boundaries, so that a
    ready check writes one probe a shard whatever the split."""
    out, lo = {}, ""
    for end, sid in shard_map.ranges():
        for path in (lo + "/.cluster-ready", lo + ".cluster-ready"):
            if sid not in out and lo < path <= end \
                    and shard_map.get_shard(path) == sid:
                out[sid] = path
        lo = end
    return out


# ------------------------------------------------- the system's topology


def load_topology(path) -> dict:
    """A ``deploy/topologies/*.json`` spec with ``scripts/start_cluster.py``'s
    defaults for what this launcher reads (``racks``,
    ``split_threshold_rps``)."""
    spec = json.loads(Path(path).read_text())
    spec.setdefault("racks", 3)
    spec.setdefault("split_threshold_rps", 100.0)
    if not spec.get("shards"):
        raise ValueError("a topology needs at least one shard")
    return spec


@dataclass
class MasterProc(ServerProc):
    shard: str


#: Probe paths of the topology's ready check, one a side of the bootstrap
#: split at ``/m`` (with two shards, the second owns the keys up to
#: ``/m``).
READY_PROBES = ("/.cluster-ready", "/z/.cluster-ready")


class _Deployment:
    """What the sharded launchers share: spawning named servers under
    ``root`` (logs in ``logs/``), the PKI, liveness checks, master kills
    and teardown. :meth:`start` runs its own event loop: call it outside
    one."""

    def __init__(self, root: str | Path, *, tls: bool,
                 cache_blocks: int | None):
        self.root = Path(root)
        self.tls = tls
        self.cache_blocks = cache_blocks
        self.procs: list[subprocess.Popen] = []
        #: shard id -> its masters' addresses.
        self.shards: dict[str, list[str]] = {}
        #: name -> master process.
        self.masters: dict[str, MasterProc] = {}
        self.chunkservers: list[ChunkServerProc] = []
        self._named: list[tuple[str, subprocess.Popen]] = []
        #: The PKI's path map (``make_test_pki``) and the client's TLS.
        self.pki: dict | None = None
        self.client_tls = None
        self._tls_args: list[str] = []
        #: Wall seconds of :meth:`start`, the PKI included.
        self.start_s = 0.0

    @property
    def all_masters(self) -> list[str]:
        return [a for addrs in self.shards.values() for a in addrs]

    def _spawn(self, name: str, mod: str, *args: str,
               env: dict | None = None) -> subprocess.Popen:
        p = spawn(self.procs, name, self.root / "logs", mod, *args, env=env)
        self._named.append((name, p))
        return p

    def _make_pki(self) -> None:
        if not self.tls:
            return
        from tpudfs_torch.common.rpc import ClientTls
        from tpudfs_torch.pki import make_test_pki

        self.pki = make_test_pki(self.root / "pki")
        self._tls_args = ["--tls-cert", self.pki["server_cert"],
                          "--tls-key", self.pki["server_key"],
                          "--tls-ca", self.pki["ca"]]
        self.client_tls = ClientTls(ca_path=self.pki["ca"])

    def _chunkserver_args(self, i: int, racks: int, masters: str,
                          configs: str, heartbeat_s: float,
                          scrub_s: float | None = 3600.0) -> list[str]:
        """A chunkserver's flags; ``scrub_s`` None leaves the scrubber at
        the chunkserver's own default (60 s)."""
        scrub = [] if scrub_s is None else ["--scrub-interval", str(scrub_s)]
        return ["--port", "0", "--data-dir", str(self.root / f"cs{i}"),
                "--masters", masters, "--config-servers", configs,
                "--rack-id", f"rack-{i % racks}",
                "--heartbeat-interval", str(heartbeat_s),
                *scrub, "--http-port", "0", *self._tls_args]

    @property
    def chunkserver_env(self) -> dict:
        """The chunkservers' environment beyond this process's own."""
        if self.cache_blocks is None:
            return {}
        return {"BLOCK_CACHE_SIZE": str(self.cache_blocks)}

    def _spawn_chunkservers(self, named_args) -> None:
        """Start the chunkservers of ``named_args`` (``(name, args)``
        pairs), data dirs ``root/<name>``, and wait for each."""
        logdir = self.root / "logs"
        started = []
        for i, (name, args) in enumerate(named_args):
            p = self._spawn(name, "tpudfs.chunkserver", *args,
                            env=self.chunkserver_env)
            started.append((name, p, self.root / name))
            if i == 0:
                # The first one builds the servers' native library if it
                # is missing; the others start once it is ready.
                wait_ready(logdir, name, p)
        for name, p, data_dir in started:
            self.chunkservers.append(ChunkServerProc(
                name, p, wait_ready(logdir, name, p), data_dir))

    async def _until(self, deadline: float, what: str, op,
                     done=lambda _out: True) -> None:
        while True:
            self._check_alive()
            try:
                if done(await op()):
                    return
                err = "not yet"
            except Exception as e:
                err = e
            if time.monotonic() > deadline:
                raise RuntimeError(f"not ready in {REGISTER_TIMEOUT_S:.0f} "
                                   f"s: {what}: {err}")
            await asyncio.sleep(0.2)

    async def _shard_ready(self, sid: str, addrs, client,
                           deadline: float) -> None:
        """``sid`` has a leader and has left safe mode."""
        from tpudfs_torch.client.client import Client

        if await find_leader_async(
                addrs, client=client,
                timeout=deadline - time.monotonic()) is None:
            raise RuntimeError(f"{sid} elected no leader in "
                               f"{REGISTER_TIMEOUT_S:.0f} s")
        shard_client = Client(list(addrs), tls=self.client_tls,
                              max_retries=0, local_reads=False)
        try:
            await self._until(deadline, f"{sid} left safe mode",
                              shard_client.safe_mode_status,
                              lambda st: not st["safe_mode"])
        finally:
            await shard_client.close()

    async def _probe(self, client, paths, deadline: float) -> None:
        """An RS(n_cs - 1, 1) probe file (every chunkserver registered)
        placed and deleted at each of ``paths``."""
        k = len(self.chunkservers) - 1
        for path in paths:
            async def probe(path=path):
                await client.create_file(path, b"ready", ec=(k, 1),
                                         overwrite=True)
                await client.delete_file(path)

            await self._until(deadline, f"a probe placed at {path}", probe)

    def _check_alive(self) -> None:
        for name, p in self._named:
            if p.poll() is not None:
                log = self.root / "logs" / f"{name}.log"
                tail = log.read_text()[-3000:] if log.exists() else ""
                raise RuntimeError(f"{name} exited with {p.returncode}:\n"
                                   f"{tail}")

    async def kill_master(self, shard_id: str, leader: bool = True,
                          client=None) -> tuple[str, str] | None:
        """SIGKILL one live master of ``shard_id`` (its members as
        :attr:`shards` names them): its leader, or when ``leader`` is
        False a live member that does not lead. Returns the victim's name
        and address, or ``None`` when ``leader`` is asked and no live
        member leads within 20 s (an election is running). Leader
        discovery goes through ``client`` (or one made here)."""
        members = set(self.shards.get(shard_id, ()))
        alive = [m for m in self.masters.values()
                 if m.addr in members and m.proc.poll() is None]
        if not alive:
            return None
        current = await find_leader_async(
            [m.addr for m in alive], tls=self.client_tls, client=client,
            timeout=20.0 if leader else 3.0)
        if leader:
            victim = next((m for m in alive if m.addr == current), None)
        else:
            victim = next((m for m in alive if m.addr != current), None)
        if victim is None:
            return None
        victim.kill()
        return victim.name, victim.addr

    def stop(self) -> None:
        terminate_all(self.procs)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class TopologyCluster(_Deployment):
    """The deployment a ``deploy/topologies/*.json`` spec describes, as OS
    processes under ``root`` (logs in ``logs/``): 1 config server
    (``cfg``), each shard's Raft group of masters (``<shard>-m<i>``),
    registered with the config server before any master boots, and the
    chunkservers (``cs<i>``, rack ``rack-{i % racks}``), each heartbeating
    to every master and to the config server. ``spares`` and the S3
    gateway are not started: neither is on the data path.

    ``tls=True`` mints a PKI under ``root/pki`` (:mod:`tpudfs_torch.pki`)
    and gives every server ``--tls-cert``, ``--tls-key`` and ``--tls-ca``:
    gRPC listeners, Raft peer channels and the blockport all speak TLS;
    ``client_tls`` is the matching ``ClientTls``. ``cache_blocks`` sets
    each chunkserver's ``BLOCK_CACHE_SIZE``.

    Ready means: every shard has a leader, no shard is in safe mode, and
    an RS(n_cs - 1, 1) probe file (every chunkserver registered) places on
    every shard (:data:`READY_PROBES`). :meth:`start` runs its own event
    loop: call it outside one."""

    def __init__(self, root: str | Path, topology, *, tls: bool = False,
                 cache_blocks: int | None = None):
        super().__init__(root, tls=tls, cache_blocks=cache_blocks)
        self.spec = load_topology(topology)
        if self.spec["chunkservers"] < 2:
            raise ValueError("a topology needs at least 2 chunkservers")
        self.config_addr = ""

    def start(self) -> "TopologyCluster":
        t0 = time.perf_counter()
        logdir = self.root / "logs"
        logdir.mkdir(parents=True, exist_ok=True)
        spec = self.spec
        try:
            self._make_pki()
            tls_args = self._tls_args
            cfg_port = free_port()
            cfg = self._spawn("cfg", "tpudfs.configserver",
                              "--port", str(cfg_port),
                              "--data-dir", str(self.root / "cfg"),
                              "--http-port", "0", *tls_args)
            self.config_addr = wait_ready(logdir, "cfg", cfg)
            # Every master address is reserved up front and every shard
            # registered before any master boots, so each master's first
            # shard-map fetch sees the final layout (the order of AddShard
            # decides the bootstrap split).
            self.shards = {
                s["id"]: [f"127.0.0.1:{free_port()}"
                          for _ in range(s["masters"])]
                for s in spec["shards"]}
            asyncio.run(self._add_shards())
            for sid, addrs in self.shards.items():
                for i, addr in enumerate(addrs):
                    name = f"{sid}-m{i}"
                    p = self._spawn(
                        name, "tpudfs.master",
                        "--port", addr.rsplit(":", 1)[1],
                        "--data-dir", str(self.root / name),
                        "--peers", ",".join(a for a in addrs if a != addr),
                        "--shard-id", sid,
                        "--config-servers", self.config_addr,
                        "--split-threshold-rps",
                        str(spec["split_threshold_rps"]),
                        "--http-port", "0", *tls_args)
                    self.masters[name] = MasterProc(name, p, addr, sid)
            for name, m in self.masters.items():
                wait_ready(logdir, name, m.proc)
            self._spawn_chunkservers([
                (f"cs{i}", self._chunkserver_args(
                    i, spec["racks"], ",".join(self.all_masters),
                    self.config_addr, 0.5))
                for i in range(spec["chunkservers"])])
            asyncio.run(self._wait_ready())
        except BaseException:
            self.stop()
            raise
        self.start_s = time.perf_counter() - t0
        return self

    async def _add_shards(self) -> None:
        """``ConfigService.AddShard`` for every shard, each retried for 30 s
        while the config server elects itself."""
        from tpudfs_torch.common.rpc import RpcClient

        rpc = RpcClient(tls=self.client_tls)
        try:
            for sid, addrs in self.shards.items():
                for attempt in range(60):
                    self._check_alive()
                    try:
                        await rpc.call(self.config_addr, "ConfigService",
                                       "AddShard",
                                       {"shard_id": sid, "peers": addrs})
                        break
                    except Exception as e:
                        if attempt == 59:
                            raise RuntimeError(
                                f"could not register {sid} with "
                                f"{self.config_addr}: {e}") from None
                        await asyncio.sleep(0.5)
        finally:
            await rpc.close()

    async def _wait_ready(self) -> None:
        """Until every shard has a leader and has left safe mode, and an
        RS(n_cs - 1, 1) probe places on every shard."""
        from tpudfs_torch.client.client import Client

        deadline = time.monotonic() + REGISTER_TIMEOUT_S
        # Two retries: a shard's first master may be a follower, whose
        # Not-Leader hint the client follows.
        client = Client(self.all_masters, config_addrs=[self.config_addr],
                        tls=self.client_tls, max_retries=2,
                        local_reads=False)
        try:
            for sid, addrs in self.shards.items():
                await self._shard_ready(sid, addrs, client, deadline)
            await client.refresh_shard_map()
            owners = {client.shard_map.get_shard(p) for p in READY_PROBES}
            if owners != set(self.shards):
                raise RuntimeError(f"the probes {READY_PROBES} land on "
                                   f"{owners}, not on every shard")
            await self._probe(client, READY_PROBES, deadline)
        finally:
            await client.close()


# ------------------------------------------------------ the Helm chart


#: The Helm chart's deployment (``deploy/helm/tpudfs``) as
#: :class:`HelmCluster` starts it: ``values.yaml``'s values and the
#: constants its templates give the servers. ``tests/test_torch_helm.py``
#: holds each against the rendered chart.
HELM = {
    # configServer.replicas (values.yaml:7), one Raft group through
    # --peers (templates/configserver.yaml:28).
    "config_replicas": 3,
    # configServer.bootstrapShards (values.yaml:10-14), --bootstrap-shards
    # on every config server; the order decides the bootstrap split.
    "shards": (("shard-a", 3), ("shard-z", 3)),
    # master.splitThresholdRps (values.yaml:18), --split-threshold-rps.
    "split_threshold_rps": 100.0,
    # chunkserver.replicas, blockCacheSize, heartbeatIntervalSecs
    # (values.yaml:24-27): BLOCK_CACHE_SIZE and --heartbeat-interval.
    "chunkservers": 5,
    "block_cache_size": 100,
    "heartbeat_interval_s": 5.0,
    # --rack-id "rack-$(( ordinal % 3 ))" (templates/chunkserver.yaml:36).
    "racks": 3,
}


class HelmCluster(_Deployment):
    """The Helm chart's deployment (:data:`HELM`) as OS processes under
    ``root`` (logs in ``logs/``):

    - ``config_replicas`` config servers (``config-<i>``), one Raft group
      through ``--peers``, each with ``--bootstrap-shards``;
    - each bootstrap shard's masters (``<shard>-m<i>``), one 3-voter Raft
      group a shard through ``--peers``, every config server in
      ``--config-servers``, ``--split-threshold-rps`` at the chart's 100
      (``split_threshold_rps``; ``split_cooldown_s`` gives
      ``--split-cooldown-secs``, the masters' 30 s when None);
    - ``spares`` spare groups of 3 masters (``spare<g>-m<i>``,
      ``--shard-id ""``, ``--peers`` of each other), each of which the
      config group allocates whole to one hot-prefix split;
    - the chunkservers (``cs<i>``, rack ``rack-{i % 3}``, ``--masters ""``:
      they find every master in the config group's map), with the chart's
      heartbeat and scrubber, and its block cache unless ``cache_blocks``
      says otherwise. ``scrub_interval_s`` gives ``--scrub-interval``: only
      the CPU tests set it, so that the smoke's ``sharded`` phase at a
      small size sees its flipped replica found within seconds.

    Departures from the chart, each forced (``departures``): the
    bootstrap shards name their masters (``shard=m1+m2+m3``) and each
    shard's masters boot as one group, where the chart boots every master
    as a spare singleton, which gives each shard three independent
    1-voter groups; the spare groups, which the chart's pool (shards x
    masters) leaves out, so that a split has a group to take; the ops
    HTTP endpoints off; no S3 gateway; one host and one disk.

    Ready means: a config leader whose map names every bootstrap shard;
    every shard a leader and out of safe mode; each spare group a leader
    over all its members; and an RS(n_cs - 1, 1) probe placed at a path in
    each shard's range as the map gives it (:func:`probe_paths`).
    ``shards`` is read from the config group's map: :meth:`refresh_shards`
    reads it again, so that a shard a split carved off shows up.
    :meth:`start` runs its own event loop: call it outside one."""

    def __init__(self, root: str | Path, *, tls: bool = True,
                 chunkservers: int | None = None,
                 cache_blocks: int | None = HELM["block_cache_size"],
                 split_threshold_rps: float | None = None,
                 split_cooldown_s: float | None = None,
                 shards: tuple = HELM["shards"], spares: int = 1,
                 scrub_interval_s: float | None = None):
        super().__init__(root, tls=tls, cache_blocks=cache_blocks)
        self.spares = spares
        self.scrub_interval_s = scrub_interval_s
        #: ``(shard id, masters)`` of each bootstrap shard, in order.
        self.bootstrap = tuple(shards)
        self.n_cs = HELM["chunkservers"] if chunkservers is None \
            else chunkservers
        if self.n_cs < 2:
            raise ValueError("the deployment needs at least 2 chunkservers")
        self.split_threshold_rps = HELM["split_threshold_rps"] \
            if split_threshold_rps is None else split_threshold_rps
        self.split_cooldown_s = split_cooldown_s
        #: The config servers' addresses, and name -> process.
        self.config_addrs: list[str] = []
        self.config_servers: dict[str, ServerProc] = {}
        #: Each spare group's masters' addresses, in boot order.
        self.spare_groups: list[list[str]] = []
        #: The config group's map, as :meth:`refresh_shards` last read it.
        self.shard_map = None

    @property
    def departures(self) -> list[str]:
        out = ["each bootstrap shard names its 3 masters and they boot as "
               "one Raft group (the chart boots every master as a spare "
               "singleton: three 1-voter groups a shard)",
               f"spare groups of 3 masters ({self.spares}) beside the "
               f"chart's pool of shards x masters"]
        if self.cache_blocks != HELM["block_cache_size"]:
            out.append(f"chunkserver block cache {self.cache_blocks} "
                       f"blocks, not the chart's "
                       f"{HELM['block_cache_size']}")
        if self.bootstrap != HELM["shards"]:
            out.append(f"bootstrap shards {list(self.bootstrap)}, not the "
                       f"chart's {list(HELM['shards'])}")
        if self.n_cs != HELM["chunkservers"]:
            out.append(f"{self.n_cs} chunkservers, not the chart's "
                       f"{HELM['chunkservers']}")
        if self.split_threshold_rps != HELM["split_threshold_rps"]:
            out.append(f"split threshold {self.split_threshold_rps} rps, "
                       f"not the chart's {HELM['split_threshold_rps']}")
        if self.split_cooldown_s is not None:
            out.append(f"split cooldown {self.split_cooldown_s} s, not the "
                       f"masters' default 30")
        if self.scrub_interval_s is not None:
            out.append(f"scrubber every {self.scrub_interval_s} s, not the "
                       f"chunkservers' default 60")
        out += ["ops HTTP endpoints off (the chart's 8080 on every server)",
                "no S3 gateway", "one host and one disk"]
        return out

    def _master_args(self, name: str, addr: str, peers, shard_id: str):
        args = ["--port", addr.rsplit(":", 1)[1],
                "--data-dir", str(self.root / name),
                "--peers", ",".join(a for a in peers if a != addr),
                "--shard-id", shard_id,
                "--config-servers", ",".join(self.config_addrs),
                "--split-threshold-rps", str(self.split_threshold_rps),
                "--http-port", "0", *self._tls_args]
        if self.split_cooldown_s is not None:
            args += ["--split-cooldown-secs", str(self.split_cooldown_s)]
        return args

    def plan(self) -> dict[str, list[tuple[str, list[str]]]]:
        """The servers :meth:`start` spawns, by kind (``config``,
        ``master``, ``spare``, ``chunkserver``): each one's name and the
        flags it is given (the chunkservers' environment is
        :attr:`chunkserver_env`). Reserves every address on first call."""
        def reserve(n):
            return [f"127.0.0.1:{free_port()}" for _ in range(n)]

        if not self.config_addrs:
            self.config_addrs = reserve(HELM["config_replicas"])
            self.shards = {sid: reserve(n) for sid, n in self.bootstrap}
            self.spare_groups = [reserve(3) for _ in range(self.spares)]
        bootstrap = ",".join(f"{sid}={'+'.join(addrs)}"
                             for sid, addrs in self.shards.items())
        out = {"config": [], "master": [], "spare": [], "chunkserver": []}
        for i, addr in enumerate(self.config_addrs):
            name = f"config-{i}"
            out["config"].append((name, [
                "--port", addr.rsplit(":", 1)[1],
                "--data-dir", str(self.root / name),
                "--peers", ",".join(a for a in self.config_addrs
                                    if a != addr),
                "--http-port", "0", *self._tls_args,
                "--bootstrap-shards", bootstrap]))
        groups = [("master", sid, addrs, f"{sid}-m")
                  for sid, addrs in self.shards.items()]
        groups += [("spare", "", addrs, f"spare{g}-m")
                   for g, addrs in enumerate(self.spare_groups)]
        for kind, sid, addrs, prefix in groups:
            for i, addr in enumerate(addrs):
                name = f"{prefix}{i}"
                out[kind].append(
                    (name, self._master_args(name, addr, addrs, sid)))
        out["chunkserver"] = [
            (f"cs{i}", self._chunkserver_args(
                i, HELM["racks"], "", ",".join(self.config_addrs),
                HELM["heartbeat_interval_s"], self.scrub_interval_s))
            for i in range(self.n_cs)]
        return out

    def start(self) -> "HelmCluster":
        t0 = time.perf_counter()
        logdir = self.root / "logs"
        logdir.mkdir(parents=True, exist_ok=True)
        try:
            self._make_pki()
            plan = self.plan()
            for name, args in plan["config"]:
                p = self._spawn(name, "tpudfs.configserver", *args)
                addr = self.config_addrs[len(self.config_servers)]
                self.config_servers[name] = ServerProc(name, p, addr)
            groups = [(sid, addr) for sid, addrs in self.shards.items()
                      for addr in addrs]
            groups += [("", addr) for addrs in self.spare_groups
                       for addr in addrs]
            for (name, args), (sid, addr) in zip(
                    plan["master"] + plan["spare"], groups):
                p = self._spawn(name, "tpudfs.master", *args)
                self.masters[name] = MasterProc(name, p, addr, sid)
            for name, c in self.config_servers.items():
                wait_ready(logdir, name, c.proc)
            for name, m in self.masters.items():
                wait_ready(logdir, name, m.proc)
            self._spawn_chunkservers(plan["chunkserver"])
            asyncio.run(self._wait_ready())
        except BaseException:
            self.stop()
            raise
        self.start_s = time.perf_counter() - t0
        return self

    def client(self, **kw):
        """The port's ``Client`` as the chart's users build it: the config
        servers alone, this deployment's TLS."""
        from tpudfs_torch.client.client import Client

        return Client(config_addrs=list(self.config_addrs),
                      tls=self.client_tls, **kw)

    async def refresh_shards(self, client=None) -> dict[str, list[str]]:
        """:attr:`shards` (and :attr:`shard_map`) read anew from the config
        group's map, through ``client`` or one made here; each master's
        ``shard`` follows the map."""
        own = client is None
        if own:
            client = self.client(max_retries=2, local_reads=False)
        try:
            if not await client.refresh_shard_map():
                raise RuntimeError("no config server answered FetchShardMap")
            sm = client.shard_map
        finally:
            if own:
                await client.close()
        self.shard_map = sm
        self.shards = {sid: sm.get_peers(sid) for sid in sm.get_all_shards()}
        owner = {a: sid for sid, addrs in self.shards.items() for a in addrs}
        for m in self.masters.values():
            m.shard = owner.get(m.addr, "")
        return self.shards

    async def _wait_ready(self) -> None:
        deadline = time.monotonic() + REGISTER_TIMEOUT_S
        wanted = {sid for sid, _ in self.bootstrap}
        client = self.client(max_retries=2, local_reads=False)
        try:
            await self._until(
                deadline, f"the config group's map names {sorted(wanted)}",
                lambda: self.refresh_shards(client),
                lambda shards: set(shards) == wanted)
            for sid, addrs in self.shards.items():
                await self._shard_ready(sid, addrs, client, deadline)
            for addrs in self.spare_groups:
                async def voters(addrs=addrs):
                    lead = await find_leader_async(addrs, client=client,
                                                   timeout=1.0)
                    if lead is None:
                        return []
                    return (await client.raft_state(lead))["config"][
                        "voters"]

                await self._until(deadline,
                                  f"a spare group's leader over {addrs}",
                                  voters,
                                  lambda v, addrs=addrs:
                                  sorted(v) == sorted(addrs))
            paths = probe_paths(self.shard_map)
            if set(paths) != wanted:
                raise RuntimeError(f"no probe path for every shard: {paths}")
            await self._probe(client, paths.values(), deadline)
        finally:
            await client.close()

    async def kill_config(self, leader: bool = True,
                          ) -> tuple[str, str] | None:
        """SIGKILL one live config server: the group's leader, or when
        ``leader`` is False a live one that does not lead. Returns its name
        and address, or ``None`` when no live config server leads within
        20 s."""
        alive = [c for c in self.config_servers.values()
                 if c.proc.poll() is None]
        current = await find_config_leader_async(
            [c.addr for c in alive], tls=self.client_tls,
            timeout=20.0 if leader else 3.0)
        if leader:
            victim = next((c for c in alive if c.addr == current), None)
        else:
            victim = next((c for c in alive if c.addr != current), None)
        if victim is None:
            return None
        victim.kill()
        return victim.name, victim.addr
