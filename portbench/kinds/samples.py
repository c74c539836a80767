"""Whole sample files read into device memory by ``DfsInfeed``, in batches,
closed loop with no emulated compute: the MLPerf Storage style of
training read, one sample a file.

Configuration: ``datasets[<dataset>]`` gives ``files`` and the sample
size's ``sample_mean_bytes`` and ``sample_std_bytes`` (sizes follow a
normal distribution, clipped positive and not rounded); ``stores``,
``replication``, ``block_size``.

Traffic parameters: ``dataset``; ``batch`` (samples a step);
``prefetch`` (``DfsInfeed``'s files in flight); ``epochs`` (the stream's
length, more than any window reads: each epoch is the files in an order
drawn from the seed); ``warm_batches`` (read before the window, from the
same stream); ``check_share``, ``check_cap`` (which samples the
reference compares, drawn from the seed; the last batch is always
compared).
"""

from __future__ import annotations

import torch

from portbench import data, reference, roofline
from portbench.kinds import Cell as Base, Keeper, Step
from portbench.stores import Stores
from portbench.trace import TracedClient, clock
from tpudfs_torch.client.local import DfsError, LocalClient
from tpudfs_torch.gpu.infeed import DfsInfeed


def landed_bytes(blocks) -> torch.Tensor:
    """A sample's bytes as they landed: its device blocks, unpadded."""
    return torch.cat([b.array.reshape(-1).view(torch.uint8)[: b.size]
                      for b in blocks])


class Cell(Base):
    STEP = "infeed.batch"

    def setup(self) -> None:
        cfg, tr = self.config, self.traffic
        ds = cfg["datasets"][tr["dataset"]]
        files = ds["files"]
        sizes = data.normal_sizes(ds["sample_mean_bytes"],
                                  ds["sample_std_bytes"], files)
        assign = data.permutation(files, self.seed, "sizes")
        self.sizes = [sizes[assign[f]] for f in range(files)]
        self.paths = [f"/{tr['dataset']}/sample_{f:04d}.npz"
                      for f in range(files)]
        self.stores = Stores(self.work_dir / "stores", cfg["stores"])
        for f, path in enumerate(self.paths):
            with self.timed("data"):
                content = self._sample(f).cpu().numpy()
            with self.timed("store"):
                self.stores.write_replicated(path, content, cfg["block_size"],
                                             cfg["replication"])
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
        self.order_wrong = self.unverified = 0
        with self.timed("warm"):
            for _ in range(tr["warm_batches"]):
                self._batch(keep=False)

    def _sample(self, f: int) -> torch.Tensor:
        return data.random_bytes(self.sizes[f], self.seed, f"sample{f}",
                                 self.device)

    def _batch(self, keep: bool = True) -> int:
        items = [next(self.samples) for _ in range(self.traffic["batch"])]
        self.sync()
        nbytes = 0
        self.last = []
        for path, blocks in items:
            self.order_wrong += path != self.paths[self.stream[self.j]]
            self.unverified += sum(not b.verified for b in blocks)
            nbytes += sum(b.size for b in blocks)
            if keep and self.keeper.keep():
                self.kept.append((self.j, blocks))
            self.last.append((self.j, blocks))
            self.j += 1
        return nbytes

    def step(self) -> Step:
        t0 = clock()
        nbytes = self._batch()
        return Step(t0, clock(), nbytes, self.traffic["batch"])

    def end_window(self) -> None:
        self.samples.close()

    def counters(self) -> dict:
        return {"rereads": self.infeed.reader.rereads}

    def work(self, steps: list[Step]) -> dict:
        return {"verified_bytes": roofline.verify_bytes(
            [s.nbytes for s in steps])}

    def check(self) -> dict:
        """Each compared sample's bytes against the file made again from
        the seed, every sample's path against the stream's order, every
        block verified; then one file read once more with one byte of a
        real copy of a replica flipped, which must be caught and read from
        another replica."""
        compared = dict(self.kept + self.last)
        self.kept = self.last = []
        wrong = sum(not reference.same_bytes(landed_bytes(blocks),
                                             self._sample(self.stream[j]))
                    for j, blocks in compared.items())
        del compared
        f = int(self.rng.integers(len(self.paths)))
        meta = self.stores.metas[self.paths[f]]
        block = meta["blocks"][int(self.rng.integers(len(meta["blocks"])))]
        self.stores.flip(block["locations"][0], block["block_id"],
                         int(self.rng.integers(block["size"])))
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
