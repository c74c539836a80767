"""DFS files as a ``torch.utils.data.Dataset`` — port of
``tpudfs/tpu/torch_data.py``.

:class:`DfsTorchDataset` wraps the port's
:class:`~tpudfs_torch.gpu.record_source.DfsRecordSource` (byte-range
fetches over a DFS client, short-circuit local reads when colocated) as a
map-style Dataset, so a standard ``DataLoader`` — shuffling, batching,
pinned memory — trains straight off DFS files. Pickling for ``DataLoader``
worker processes comes from the source (the client is re-created lazily per
process from its picklable ``client_factory``).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence
from typing import Any

import torch
from torch.utils.data import Dataset

from tpudfs_torch.gpu.record_source import DfsRecordSource


class DfsTorchDataset(Dataset):
    """Map-style dataset of fixed-size records stored in DFS files.

    ``transform`` maps the raw numpy record to the sample a model consumes;
    by default records come back as torch tensors of the source dtype."""

    def __init__(self, client_factory: Callable[[], Any],
                 paths: Sequence[str], record_bytes: int,
                 dtype: str = "uint8",
                 transform: Callable[[Any], Any] | None = None):
        self.source = DfsRecordSource(client_factory, paths, record_bytes,
                                      dtype=dtype)
        self.transform = transform

    def __len__(self) -> int:
        return len(self.source)

    def __getitem__(self, idx: int):
        record = self.source[idx]
        if self.transform is not None:
            return self.transform(record)
        # .copy(): frombuffer memory is read-only; torch wants writable.
        return torch.from_numpy(record.copy())

    def close(self) -> None:
        self.source.close()
