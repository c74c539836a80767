"""The plain reference that decides ``correct``.

It compares what the port landed on the device with the inputs the
harness made from ``--seed`` (``portbench.data``), made again here, never
with anything the port packed, stored or derived: the tensor tree before
it was packed, and each sample file's bytes before they were stored.
Plain PyTorch; it imports nothing of the port.
"""

from __future__ import annotations

import torch


def same_tensor(got, want: torch.Tensor, device: torch.device) -> bool:
    """Bit-exact, of the same dtype and shape, on ``device``."""
    return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
            and got.shape == want.shape and got.device == device
            and torch.equal(got.reshape(-1).view(torch.uint8),
                            want.reshape(-1).view(torch.uint8)))


def same_tree(got: dict, want: dict, device: torch.device) -> bool:
    """Every tensor of ``want`` and no other, each :func:`same_tensor`."""
    return sorted(got) == sorted(want) and all(
        same_tensor(got[name], want[name], device) for name in want)


def same_bytes(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Two uint8 tensors of equal length and content."""
    return got.shape == want.shape and torch.equal(got, want.to(got.device))
