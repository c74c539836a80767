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
"""

from __future__ import annotations

import asyncio
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
class ChunkServerProc:
    name: str
    proc: subprocess.Popen
    addr: str
    data_dir: Path

    def kill(self) -> None:
        """SIGKILL, and reap."""
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)


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
