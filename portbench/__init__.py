"""The benchmark of the PyTorch/CUDA port (``tpudfs_torch``).

One command runs one cell once::

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything the harness runs is found by name from ``BENCHMARK.json`` at the
root of the checkout: a cell's configuration in ``configs/<name>.json``, its
traffic mix in ``traffic/<name>.json`` (data read by the generator that its
``kind`` names, ``kinds/<kind>.py``) and each metric's reader in
``metrics/<name>.py``. See ``README.md``.

The harness imports the port and nothing else of the repository: no module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``tpudfs`` is ever
loaded in its process, and it starts no server.
"""
