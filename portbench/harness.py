"""One run of one cell: the generic part of every cell.

Reads ``BENCHMARK.json``, finds the cell's configuration, traffic and
metric files by name, lays out, warms up and writes the layout back to
the disk (``setup_s`` counts from the start of the process), runs the
measured window as a closed loop of the
generator's steps until the first step that ends after ``seconds``,
reads the device's memory peak, stops what the window ran, lets the
reference judge what landed, and reduces the run to the result line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import shutil
import sys
import tempfile
import threading
import traceback
from pathlib import Path

import torch

from portbench import faults
from portbench.kinds import Step
from portbench.trace import Spans, clock, device_profile
from tpudfs_torch.common import native
from tpudfs_torch.graft_entry import launch_counts

HERE = Path(__file__).resolve().parent
#: Seconds to wait, in all, for the threads that the run started to end.
JOIN_S = 30.0


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def metric_entries(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. A metric without a
    ``workloads`` list belongs to every cell (a per-layer one to every
    cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclasses.dataclass
class Context:
    """What a metric's reader reads. ``window``: host-clock start and end
    of the measured window; ``steps``: its closed-loop steps; ``spans``:
    the harness's spans (traced runs); ``stages``: each window restore's ``stage_s``; ``counters``:
    the program's counters over the window (kernel launches, native
    engine calls, the generator's own); ``work``: the window's device work
    in bytes; ``device``: the window's device trace (traced runs on a
    card); ``device_kind``: the card's name."""

    setup_s: float
    window: tuple[float, float]
    steps: list[Step]
    spans: list
    stages: list
    counters: dict
    work: dict
    device: object
    device_kind: str

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def in_window(self, name: str) -> list:
        """Spans called ``name`` that began inside the window."""
        a, b = self.window
        return [s for s in self.spans if s[0] == name and a <= s[1] <= b]


def _counters(cell) -> dict:
    return {"launches": launch_counts(), "engine_calls": native.call_counts(),
            **cell.counters()}


def _delta(after: dict, before: dict) -> dict:
    return {k: _delta(v, before[k]) if isinstance(v, dict) else v - before[k]
            for k, v in after.items()}


def _join_threads(threads: set) -> None:
    """Wait for every thread the run started; name any left running."""
    deadline = clock() + JOIN_S
    for t in threading.enumerate():
        if t not in threads and t is not threading.current_thread():
            t.join(max(0.0, deadline - clock()))
            if t.is_alive():
                print(f"portbench: thread {t.name} still running",
                      file=sys.stderr)


def run_cell(bench: dict, name: str, *, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             fault: str | None = None, overrides: dict | None = None
             ) -> tuple[dict, dict]:
    """Run cell ``name`` once. Returns the result line (without its
    ``checks``) and the checks, ``{name: (value, limit)}``.

    ``fault`` plants one of ``portbench.faults`` in the program (the
    control and the tests); ``overrides`` replaces keys of the cell's
    configuration and traffic (``{"config": {...}, "traffic": {...}}``,
    for the tests' small sizes)."""
    overrides = overrides or {}
    cell_entry = find(bench["workloads"], name, "workload")
    config = load_json(bench_path(find(bench["configs"],
                                       cell_entry["config"], "config")["file"]))
    config.update(overrides.get("config", {}))
    traffic = load_json(HERE / "traffic" / f"{cell_entry['traffic']}.json")
    traffic.update(overrides.get("traffic", {}))
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    entries = metric_entries(bench, name, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in entries}
    cuda = device.type == "cuda"
    started_s = clock() - t_start
    threads = set(threading.enumerate())
    work_dir = Path(tempfile.mkdtemp(prefix=f"portbench-{name}-"))
    spans = Spans() if trace else None
    cell = kind.Cell(config=config, traffic=traffic, seed=seed,
                     device=device, work_dir=work_dir, spans=spans)
    try:
        with faults.planted(fault):
            cell.setup()
            with cell.timed("sync"):
                cell.durable()
            setup_s = clock() - t_start
            print("portbench setup_s " + json.dumps(
                {"start": started_s, **cell.setup_parts, "all": setup_s}),
                file=sys.stderr)
            before = _counters(cell)
            steps, failed = [], 0
            with (device_profile(work_dir, cuda) if trace
                  else contextlib.nullcontext({})) as box:
                w0 = clock()
                while True:
                    try:
                        step = cell.step()
                    except Exception:
                        traceback.print_exc(file=sys.stderr)
                        failed += 1
                        break
                    steps.append(step)
                    if spans is not None:
                        spans.add(cell.STEP, step.t0, step.t1, step.nbytes)
                    if step.t1 - w0 >= seconds:
                        break
                w1 = clock()
            counters = _delta(_counters(cell), before)
            peak = torch.cuda.max_memory_allocated(device) if cuda else 0
            cell.end_window()
            checks = cell.check()
    finally:
        cell.close()
        _join_threads(threads)
        shutil.rmtree(work_dir, ignore_errors=True)
    ctx = Context(
        setup_s=setup_s, window=(w0, w1), steps=steps,
        spans=spans.items if spans else [],
        stages=cell.stages, counters=counters,
        work=cell.work(steps), device=box.get("trace"),
        device_kind=torch.cuda.get_device_name(device) if cuda else "cpu")
    metrics = {}
    for m in entries:
        value = readers[m["name"]](ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": not failed and all(v <= lim for v, lim in checks.values()),
        "attempted": len(steps) + failed, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": ctx.device_kind, "count": 1,
                   "memory_peak_bytes": peak}}
    if ctx.device is not None:
        result["device"].update(busy_s=ctx.device.busy_s,
                                window_s=ctx.device.window_s)
        result["breakdown"] = ctx.device.breakdown(spans.items)
    return result, checks


def bench_path(relative: str) -> Path:
    """A path of ``BENCHMARK.json``, from the root of the checkout."""
    return HERE.parent / relative
