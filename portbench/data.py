"""The benchmark's inputs, made from ``--seed``: the same seed gives the
same bytes, tensors and orders on every run.

Bulk data is made on the device by a ``torch.Generator`` in a few large
calls and copied to the host once, where the stores need it. Sizes never
depend on the seed: every seed gets the same set of sizes, in its own
order, so two seeds do the same work.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one stream of inputs (``tag``) of run ``seed``: any whole
    number, the large ones included, maps to a seed below 2**63."""
    words = [int(b) for b in tag.encode()]
    state = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *words])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def random_bytes(nbytes: int, seed: int, tag: str,
                 device: torch.device) -> torch.Tensor:
    """``nbytes`` random bytes as a uint8 tensor on ``device``."""
    words = torch.randint(-(1 << 31), 1 << 31, (-(-nbytes // 4),),
                          dtype=torch.int32, device=device,
                          generator=generator(seed, tag, device))
    return words.view(torch.uint8)[:nbytes]


def normal_sizes(mean: float, std: float, n: int) -> list[int]:
    """``n`` sizes that follow a normal distribution of ``mean`` and
    ``std``: its quantiles at (i + 0.5) / n, clipped to at least one byte.
    A fixed set, so that no seed changes the bytes a pass reads."""
    dist = statistics.NormalDist(mean, std)
    return [max(1, round(dist.inv_cdf((i + 0.5) / n))) for i in range(n)]


def permutation(n: int, seed: int, tag: str) -> list[int]:
    rng = np.random.default_rng(sub_seed(seed, tag))
    return [int(i) for i in rng.permutation(n)]


def ckpt_tree(n: int, flags: int, seed: int,
              device: torch.device) -> dict[str, torch.Tensor]:
    """One data-parallel rank's mixed-precision training state, made on
    ``device``: flat fp32 master weights (``params``) and Adam moments
    (``adam_m``, ``adam_v``) of ``n`` elements each, the bf16 weights the
    forward pass reads (``model``: ``params`` rounded), an int8 ``flags``
    tensor and an int64 ``step``. The last three are not 4-byte dtypes."""
    gen = generator(seed, "ckpt", device)
    tree = {name: torch.randn(n, generator=gen, device=device)
            for name in ("params", "adam_m", "adam_v")}
    tree["model"] = tree["params"].to(torch.bfloat16)
    tree["flags"] = torch.randint(-128, 128, (flags,), dtype=torch.int8,
                                  generator=gen, device=device)
    tree["step"] = torch.tensor(1000 + abs(int(seed)) % 1_000_000,
                                dtype=torch.int64, device=device)
    return tree
