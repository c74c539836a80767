"""Whole sample files read into device memory by ``DfsInfeed``, as
``samples`` reads them, from an RS(k, m) erasure-coded copy with one
chunkserver down: the training read of HDFS's erasure-coded data.

Configuration: as ``samples``, with ``ec`` ([k, m]) in place of
``replication``; ``stores`` at least k + m.

Traffic parameters: as ``samples``, and ``lost_store`` (the index of the
store that is down: it holds no shard and answers at once) and
``placement``: ``"rotated"``, shard j of the dataset's g-th block (in
write order) on store (g + j) mod ``stores``, as HDFS gives each block
group its own nodes. A block whose lost shard is a data shard is rebuilt
on the device; any other is joined from its data shards on the host.

Counters: the reader's ``rereads`` and ``ec_rebuilds``, and the port's
``ec.*`` counters (:data:`EC_COUNTERS`, 0 in a port that lacks them).
"""

from __future__ import annotations

import numpy as np

from portbench import data, reference, roofline
from portbench.kinds import Keeper, samples
from portbench.kinds.samples import landed_bytes
from portbench.stores import Stores, block_crc, block_meta
from portbench.trace import TracedClient
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.common import trace
from tpudfs_torch.common.erasure import encode, shard_len
from tpudfs_torch.gpu.infeed import DfsInfeed

#: The port's counters of its EC read path.
EC_COUNTERS = ("ec.shard_bytes", "ec.blocks_assembled", "ec.blocks_rebuilt")


class Cell(samples.Cell):
    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        if tr["placement"] != "rotated":
            raise ValueError(f"unknown placement {tr['placement']!r}")
        ds = cfg["datasets"][tr["dataset"]]
        files = ds["files"]
        sizes = data.normal_sizes(ds["sample_mean_bytes"],
                                  ds["sample_std_bytes"], files)
        assign = data.permutation(files, self.seed, "sizes")
        self.sizes = [sizes[assign[f]] for f in range(files)]
        self.paths = [f"/{tr['dataset']}/sample_{f:04d}.npz"
                      for f in range(files)]
        self.stores = Stores(self.work_dir / "stores", cfg["stores"])
        #: Each file's blocks' lost shard index, in block order.
        self.lost_index: list[list[int]] = []
        for f, path in enumerate(self.paths):
            with self.timed("data"):
                content = self._sample(f).cpu().numpy()
            with self.timed("store"):
                self._write_ec(path, content)
        self.stream = [f for e in range(tr["epochs"])
                       for f in data.permutation(files, self.seed, f"epoch{e}")]
        client = LocalClient(self.stores.local(), self.stores.metas)
        self.client = client if self.spans is None \
            else TracedClient(client, self.spans)
        self.infeed = DfsInfeed(self.client, [self.paths[f] for f in self.stream],
                                [self.device], prefetch=tr["prefetch"])
        self.samples = self.infeed.as_sync_iterator()
        self.keeper = Keeper(self.seed, tr["check_share"], tr["check_cap"])
        self.j = 0
        self.kept: list[tuple[int, list]] = []
        self.last: list[tuple[int, list]] = []
        #: The files of each window step, in order.
        self.step_files: list[list[int]] = []
        self.order_wrong = self.unverified = 0
        with self.timed("warm"):
            for _ in range(tr["warm_batches"]):
                self._batch(keep=False)

    def _write_ec(self, path: str, content: np.ndarray) -> None:
        """``content`` as an RS(k, m) file, placed rotated, the lost
        store's shards never written."""
        k, m = self.config["ec"]
        bs = self.config["block_size"]
        n, lost = len(self.stores.addrs), self.traffic["lost_store"]
        tag = path.strip("/").replace("/", "_")
        first = sum(map(len, self.lost_index))  # the file's first block's g
        blocks, lost_index = [], []
        for i, off in enumerate(range(0, len(content), bs)):
            piece = content[off : off + bs]
            bid = f"blk_{tag}_{i}"
            g = first + i
            addrs = [self.stores.addrs[(g + j) % n] for j in range(k + m)]
            for j, shard in enumerate(encode(piece, k, m)):
                if (g + j) % n != lost:
                    self.stores._write(addrs[j], bid,
                                       np.frombuffer(shard, dtype=np.uint8))
            blocks.append(block_meta(bid, len(piece), addrs, block_crc(piece),
                                     k=k, m=m))
            lost_index.append((lost - g) % n)
        self.stores.metas[path] = {"path": path, "size": len(content),
                                   "blocks": blocks}
        self.lost_index.append(lost_index)

    def step(self):
        step = super().step()
        self.step_files.append([self.stream[j] for j, _b in self.last])
        return step

    def counters(self) -> dict:
        counts = trace.counts()
        return {"rereads": self.infeed.reader.rereads,
                "ec_rebuilds": self.infeed.reader.ec_rebuilds,
                **{name: counts.get(name, 0) for name in EC_COUNTERS}}

    def work(self, steps) -> dict:
        """The window's landed bytes, each verified once; the rebuild's
        bytes (``roofline.rebuild_bytes``) of each landed block whose lost
        shard is a data shard; the EC blocks landed."""
        k, _m = self.config["ec"]
        files = [f for fs in self.step_files[: len(steps)] for f in fs]
        blocks = [(b["size"], j) for f in files for b, j in zip(
            self.stores.metas[self.paths[f]]["blocks"], self.lost_index[f])]
        return {"verified_bytes": roofline.verify_bytes(
                    [s.nbytes for s in steps]),
                "rebuild_bytes": sum(roofline.rebuild_bytes([size], k, (j,))
                                     for size, j in blocks),
                "blocks": len(blocks)}

    def check(self) -> dict:
        """As ``samples``: each compared sample's bytes against the file
        made again from the seed, the stream's order, every block
        verified. Then one file read once more with one byte flipped in a
        present data shard of one of its blocks, inside the block's own
        bytes: k + m - 2 good shards are left, at least k, so the flip
        must be caught and the block rebuilt from the others."""
        compared = dict(self.kept + self.last)
        self.kept = self.last = []
        wrong = sum(not reference.same_bytes(landed_bytes(blocks),
                                             self._sample(self.stream[j]))
                    for j, blocks in compared.items())
        del compared
        k, _m = self.config["ec"]
        f = int(self.rng.integers(len(self.paths)))
        b = int(self.rng.integers(len(self.lost_index[f])))
        block = self.stores.metas[self.paths[f]]["blocks"][b]
        slen = shard_len(block["size"], k)
        present = [j for j in range(k) if j != self.lost_index[f][b]
                   and block["size"] > j * slen]
        j = present[int(self.rng.integers(len(present)))]
        self.stores.flip(block["locations"][j], block["block_id"], int(
            self.rng.integers(min(slen, block["size"] - j * slen))))
        try:
            (_path, blocks), = DfsInfeed(self.client, [self.paths[f]],
                                         [self.device]).as_sync_iterator()
            probe_wrong = int(not reference.same_bytes(landed_bytes(blocks),
                                                       self._sample(f)))
        except DfsError:
            probe_wrong = 1
        return {"samples_wrong": (wrong, 0),
                "order_wrong": (self.order_wrong, 0),
                "blocks_unverified": (self.unverified, 0),
                "tamper_wrong": (probe_wrong, 0)}
