"""The traffic generators. A traffic file (``traffic/<name>.json``) names
its generator by ``kind``; ``kinds/<kind>.py`` defines ``Cell``, which
lays out the cell's data from the seed, warms up, runs one closed-loop
step at a time in the measured window and checks what landed against the
reference once the window has closed."""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from portbench import data


@dataclasses.dataclass
class Step:
    """One closed-loop step of the window: host-clock start and end (ended
    by a synchronize), the bytes it landed on the device and the items
    (restores, samples) they hold."""

    t0: float
    t1: float
    nbytes: int
    items: int


class Keeper:
    """Which landed results the check compares: each with probability
    ``share``, drawn from the seed, at most ``cap`` of them."""

    def __init__(self, seed: int, share: float, cap: int):
        self.rng = np.random.default_rng(data.sub_seed(seed, "check"))
        self.share = share
        self.left = cap

    def keep(self) -> bool:
        if self.left and self.rng.random() < self.share:
            self.left -= 1
            return True
        return False


class Cell:
    """What every generator shares. ``spans`` is None in an untraced run."""

    #: The name of a step's span.
    STEP = "step"

    def __init__(self, *, config: dict, traffic: dict, seed: int,
                 device: torch.device, work_dir: Path, spans=None):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.work_dir = Path(work_dir)
        self.spans = spans
        self.rng = np.random.default_rng(data.sub_seed(seed, "probe"))
        #: Each window step's ``stage_s`` where the entry reports one.
        self.stages: list[dict] = []
        #: Set-up's host seconds by part (``data``, ``pack``, ``store``,
        #: ``warm``, ``sync``), printed on standard error.
        self.setup_parts: dict[str, float] = {}

    @contextlib.contextmanager
    def timed(self, part: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.setup_parts[part] = self.setup_parts.get(part, 0.0) + \
                time.perf_counter() - t0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def counters(self) -> dict:
        """The program's own cumulative counters this cell reads."""
        return {}

    def work(self, steps: list[Step]) -> dict:
        """The device work of ``steps``, in bytes (``portbench.roofline``)."""
        return {}

    def durable(self) -> None:
        """Write the cell's layout back to the disk, once, at the end of
        set-up, so that no write-back runs in the measured window."""
        stores = getattr(self, "stores", None)
        if stores is not None:
            stores.sync()

    def end_window(self) -> None:
        """Stop what the window ran (its threads)."""

    def close(self) -> None:
        """Free what is left."""
