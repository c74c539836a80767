"""Checkpoint restores, back to back: one data-parallel rank's shard, laid
out as ``CheckpointManager`` saves it, restored into device memory by
``restore_shard_device`` one call at a time (a closed loop).

Traffic parameters (``traffic/<name>.json``):

- ``copy``: ``"hot"`` reads the 3x-replicated hot copy (the cold copy is
  never read, so it is not written); ``"cold"``: the hot copy's replicas
  are gone and the RS(k, m) cold copy has lost ``lost_shards`` of every
  block (never written), so every block is rebuilt;
- ``check_share``, ``check_cap``: which window restores the reference
  compares, drawn from the seed; the last one is always compared.

Configuration (``configs/<name>.json``): ``checkpoint`` (``params_total``
over ``ranks`` ranks, ``flags_elements``), ``stores``, ``block_size``,
``hot_replicas``, ``ec``.
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

from portbench import data, reference, roofline
from portbench.kinds import Cell as Base, Keeper, Step
from portbench.stores import Stores
from portbench.trace import TracedClient, clock
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.common import ckptpaths
from tpudfs_torch.common.checksum import crc32c
from tpudfs_torch.gpu import checkpoint
from tpudfs_torch.gpu.hbm_reader import HbmReader

BASE = "/ckpt"


class Cell(Base):
    STEP = "restore"

    def setup(self) -> None:
        cfg, ck = self.config, self.config["checkpoint"]
        self.n = ck["params_total"] // ck["ranks"]
        self.cold = self.traffic["copy"] == "cold"
        self.k, self.m = cfg["ec"]
        self.lost = tuple(self.traffic.get("lost_shards", ()))
        with self.timed("data"):
            tree = data.ckpt_tree(self.n, ck["flags_elements"], self.seed,
                                  self.device)
            self.sync()
        with self.timed("pack"):
            payload, specs = checkpoint.pack_shard(tree)
        del tree
        hot = ckptpaths.shard_data_path(BASE, 1, 0)
        cold = ckptpaths.shard_ec_path(BASE, 1, 0)
        raw = np.frombuffer(payload, dtype=np.uint8)
        bs = cfg["block_size"]
        with self.timed("store"):
            self.stores = Stores(self.work_dir / "stores", cfg["stores"])
            self.hot = self.stores.write_replicated(
                hot, raw, bs, cfg["hot_replicas"], write=not self.cold)
            if self.cold:
                self.stores.write_ec(cold, raw, bs, self.k, self.m, self.lost)
        self.spec = {"shard": 0, "path": hot, "ec_path": cold,
                     "size": len(payload), "crc32c": crc32c(payload),
                     "tensors": [t.to_dict() for t in specs]}
        del payload, raw
        self.block_sizes = [b["size"] for b in self.hot["blocks"]]
        client = LocalClient(self.stores.local(), self.stores.metas)
        self.client = client if self.spans is None \
            else TracedClient(client, self.spans)
        self.reader = HbmReader(self.client, [self.device])
        self.loop = asyncio.new_event_loop()
        self.keeper = Keeper(self.seed, self.traffic["check_share"],
                             self.traffic["check_cap"])
        self.kept: list[dict] = []
        self.last: dict | None = None
        with self.timed("warm"):  # builds and loads the kernels, the engine
            self._restore()

    def _restore(self, stage: dict | None = None) -> dict:
        stats = {"degraded_shard_reads": 0}
        out = self.loop.run_until_complete(checkpoint.restore_shard_device(
            self.reader, self.client, self.spec, self.device, stats,
            stage_s=stage))
        self.sync()
        return out

    def step(self) -> Step:
        stage = {} if self.spans is not None else None
        t0 = clock()
        out = self._restore(stage)
        t1 = clock()
        if stage is not None:
            self.stages.append(stage)
        if self.keeper.keep():
            self.kept.append(out)
        self.last = out
        return Step(t0, t1, self.spec["size"], 1)

    def counters(self) -> dict:
        return {"rereads": self.reader.rereads,
                "ec_rebuilds": self.reader.ec_rebuilds}

    def work(self, steps: list[Step]) -> dict:
        n = len(steps)
        return {"verified_bytes": n * roofline.verify_bytes(self.block_sizes),
                "rebuild_bytes": n * roofline.rebuild_bytes(
                    self.block_sizes, self.k, self.lost) if self.cold else 0,
                "blocks": n * len(self.block_sizes)}

    def check(self) -> dict:
        """The window's sampled restores and its last one against the tree
        made again from the seed; then one more restore with one byte of a
        real copy flipped: of a hot replica, which must be caught and read
        from another replica, or of a surviving cold shard, which leaves
        too few good shards, so the restore must fail rather than return
        wrong tensors."""
        compared = self.kept + ([self.last] if self.last is not None else [])
        self.kept, self.last = [], None
        ck = self.config["checkpoint"]
        want = data.ckpt_tree(self.n, ck["flags_elements"], self.seed,
                              self.device)
        wrong = sum(not reference.same_tree(out, want, self.device)
                    for out in compared)
        del compared
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        b = int(self.rng.integers(len(self.block_sizes)))
        if self.cold:
            survivors = [j for j in range(self.k + self.m)
                         if j not in self.lost][: self.k]
            j = survivors[int(self.rng.integers(len(survivors)))]
            block = self.stores.metas[self.spec["ec_path"]]["blocks"][b]
            self.stores.flip(block["locations"][j], block["block_id"], int(
                self.rng.integers(-(-block["size"] // self.k))))
        else:
            block = self.hot["blocks"][b]
            self.stores.flip(block["locations"][0], block["block_id"],
                             int(self.rng.integers(block["size"])))
        try:
            probe_wrong = int(not reference.same_tree(self._restore(), want,
                                                      self.device))
        except DfsError:
            probe_wrong = 0 if self.cold else 1
        return {"restores_wrong": (wrong, 0), "tamper_wrong": (probe_wrong, 0)}

    def close(self) -> None:
        loop = getattr(self, "loop", None)
        if loop is not None:
            loop.run_until_complete(loop.shutdown_default_executor())
            loop.close()
