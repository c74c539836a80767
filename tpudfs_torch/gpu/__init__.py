"""GPU data plane: hand-written Hopper kernels, their plain twins, the HBM
reader. Counterpart of ``tpudfs/tpu``.

Device policy (the port of ``tpudfs.tpu.on_tpu``): an entry point runs on
``cuda:0`` unless the caller names another device. There is no silent CPU
fallback: without a card, a caller that did not ask for the CPU gets an
error. Each kernel wrapper picks its path from the device of the tensor it
is given — CUDA launches the kernel (or raises), CPU runs the plain twin.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0``.

    Raises RuntimeError when a CUDA device is asked for (explicitly or by
    default) and none is available."""
    if device is None:
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass torch.device('cpu') "
                "explicitly to run the plain PyTorch path"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


_DEVICE_CONSTANTS: dict = {}


def device_constant(key, device: torch.device, build) -> torch.Tensor:
    """A constant table on ``device``, uploaded once per (key, device).

    ``build()`` returns the host numpy array. Only constant inputs of the
    kernels are kept here (CRC bit-plane tables, combine-fold tables,
    GF(2^8) coefficient bit-planes); nothing compiled is cached."""
    device = torch.device(device)
    ck = (key, str(device))
    t = _DEVICE_CONSTANTS.get(ck)
    if t is None:
        t = host_to_device(build(), device)
        _DEVICE_CONSTANTS[ck] = t
    return t


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``. On the CPU the tensor IS
    the array's memory when the array is writable and contiguous (callers
    hand in a fresh buffer, never one they reuse); a frozen array (an
    lru-cached table) is copied first. uint32 travels as int32 and is
    viewed back on arrival: a same-size view, no conversion."""
    arr = np.asarray(arr)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, order="C")
    if arr.dtype == np.uint32:
        return torch.from_numpy(arr.view(np.int32)).to(device).view(torch.uint32)
    return torch.from_numpy(arr).to(device)


# --- uint32 helpers --------------------------------------------------------
# torch has no shifts on uint32 and an arithmetic >> on int32, so the plain
# twins compute in int64 (values kept in [0, 2**32)) and turn the result
# into uint32 only at the API boundary.


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32) \
        .view(torch.uint32)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """uint32 tensor (any device) -> host numpy uint32 (one copy)."""
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def xor_reduce(x: torch.Tensor) -> torch.Tensor:
    """XOR over the last dimension by pairwise halving (torch has no XOR
    reduction); an odd width folds its last column into the first."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        y = x[..., :half] ^ x[..., half : 2 * half]
        if n % 2:
            y[..., 0] ^= x[..., n - 1]
        x = y
    return x[..., 0]
