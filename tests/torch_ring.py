"""Host helpers for the port's ring tests: a host array split into the
per-position tensor list that ``tpudfs_torch.gpu.ici_replication`` takes
as a sharded array, and back. Imports neither JAX nor the JAX package, so
the card tests (run without the conftest) use it too."""

from __future__ import annotations

import numpy as np
import torch

from tpudfs_torch.gpu import host_to_device, u32_to_numpy
from tpudfs_torch.gpu.ici_replication import Mesh


def shard(arr: np.ndarray, mesh: Mesh) -> list[torch.Tensor]:
    """Split a host array into equal row blocks, one per flat position, each
    copied to its position's device (the reference's ``device_put`` with
    the mesh's row sharding)."""
    devs = mesh.positions()
    if arr.shape[0] % len(devs):
        raise ValueError(f"{arr.shape[0]} rows do not split over "
                         f"{len(devs)} positions")
    return [host_to_device(np.array(part), d)
            for part, d in zip(np.split(arr, len(devs)), devs)]


def unshard(parts: list[torch.Tensor]) -> np.ndarray:
    """The per-position tensors as one host array (their concatenation, the
    reference's ``np.asarray`` of a sharded array)."""
    return np.concatenate([u32_to_numpy(p) if p.dtype == torch.uint32
                           else p.cpu().numpy() for p in parts])
