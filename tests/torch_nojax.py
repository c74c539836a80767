"""Run a snippet of the port's tests in a fresh interpreter that cannot
import JAX: its first act is to put a ``sys.meta_path`` finder in front
that refuses ``jax`` and ``jaxlib``, as on a host where they are not
installed. The snippet's ``result`` comes back as a dict, with the
``jax*`` and ``tpudfs.tpu*`` modules loaded at its end listed in it.

The interpreter runs PyTorch's CPU ops on one thread (``OMP_NUM_THREADS``):
the write group runs them on asyncio worker threads, each of which would
start its own OpenMP team, and on a host loaded by the test run's other
workers the first such team took longer to come up than the rest of a
soak round."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PRELUDE = '''
import importlib.abc, json, sys

class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _RefuseJax())

def _loaded_jax() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib")
                  or m == "tpudfs.tpu" or m.startswith("tpudfs.tpu."))
'''


def process_without_jax(body: str, timeout: float = 120
                        ) -> subprocess.CompletedProcess:
    """Run ``body`` after the prelude; the finished process, its output
    captured as text."""
    code = _PRELUDE + textwrap.dedent(body)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def run_without_jax(body: str, timeout: float = 120) -> dict:
    """Run ``body`` after the prelude; it binds ``result`` to a JSON-able
    dict. Returns that dict, with ``loaded_jax`` (the JAX or ``tpudfs.tpu``
    modules in ``sys.modules`` at the end) added."""
    out = process_without_jax(
        textwrap.dedent(body)
        + '\nresult["loaded_jax"] = _loaded_jax()\n'
          'print("RESULT " + json.dumps(result))\n', timeout)
    if out.returncode != 0:
        raise AssertionError(f"snippet failed (rc {out.returncode}):\n"
                             f"{out.stderr[-4000:]}")
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])
