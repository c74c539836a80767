"""Faults planted in the port, under a run that must then come out not
correct: the control (``portbench.control``) and the tests.

- ``no_verify``: the control. The configuration's integrity guarantee is
  broken: every replica and shard is read raw (no sidecar check), no
  device CRC verdict is taken, and a tensor's host CRC always agrees;
- ``altered``: one byte of what the entry produced is flipped after its
  checks passed (a restored tensor, a landed sample);
- ``unchanged``: a restore returns zeros in place of what it read;
- ``half_batch``: half of each batch is left out (every other sample of
  the infeed);
- ``misordered``: each pair of consecutive samples swapped.

Each patches the port's own functions in this process.
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.gpu import checkpoint
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.gpu.infeed import DfsInfeed

FAULTS = ("no_verify", "altered", "unchanged", "half_batch", "misordered")


class _AlwaysEqual(int):
    def __eq__(self, other):
        return True

    def __ne__(self, other):
        return False

    __hash__ = int.__hash__


def _flip(t: torch.Tensor) -> None:
    t.reshape(-1).view(torch.uint8)[0] ^= 1


def _pairs_swapped(items):
    held = None
    for item in items:
        if held is None:
            held = item
        else:
            yield item
            yield held
            held = None
    if held is not None:
        yield held


def _patches(name: str) -> list:
    read_local = LocalClient._read_local
    finish = HbmReader._finish_block
    restore = checkpoint.restore_shard_device
    samples = DfsInfeed.as_sync_iterator

    if name == "no_verify":
        async def raw_read(self, addr, block_id, offset, length, verify=True,
                           **kw):
            return await read_local(self, addr, block_id, offset, length,
                                    verify=False, **kw)

        async def unchecked(self, block, words, size, verify):
            return await finish(self, block, words, size, False)

        return [mock.patch.object(LocalClient, "_read_local", raw_read),
                mock.patch.object(HbmReader, "_finish_block", unchecked),
                mock.patch.object(checkpoint, "crc32c",
                                  lambda raw: _AlwaysEqual(0))]
    if name in ("altered", "unchanged"):
        async def restored(*args, **kw):
            out = await restore(*args, **kw)
            if name == "unchanged":
                return {k: torch.zeros_like(v) for k, v in out.items()}
            _flip(out["params"])
            return out

        def flipped_samples(self):
            for path, blocks in samples(self):
                _flip(blocks[0].array)
                yield path, blocks

        out = [mock.patch.object(checkpoint, "restore_shard_device", restored)]
        if name == "altered":
            out.append(mock.patch.object(DfsInfeed, "as_sync_iterator",
                                         flipped_samples))
        return out
    if name == "half_batch":
        def every_other(self):
            for i, item in enumerate(samples(self)):
                if i % 2 == 0:
                    yield item

        return [mock.patch.object(DfsInfeed, "as_sync_iterator", every_other)]
    if name == "misordered":
        def swapped_samples(self):
            yield from _pairs_swapped(samples(self))

        return [mock.patch.object(DfsInfeed, "as_sync_iterator",
                                  swapped_samples)]
    raise ValueError(f"no fault named {name!r}; faults: {FAULTS}")


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` planted for the body; none for None."""
    with contextlib.ExitStack() as stack:
        for patch in _patches(name) if name else []:
            stack.enter_context(patch)
        yield
