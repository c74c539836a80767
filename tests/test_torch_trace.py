"""The port's tracer (``tpudfs_torch.common.trace``) and what reads it: off
it records nothing; on, a hot and a cold CPU restore and a ``DfsInfeed``
read give every span of the read path, each child inside its parent and
parented across ``asyncio.to_thread``; ``stage_s`` is the restore spans'
durations; the upload counters are the bytes uploaded, and the tensor
CRC counters the bytes checked by their own CRC; a degraded restore's
tensors die with their last reference; and the benchmark's
readers of these spans (``portbench.program_trace``), its two-point clock
mapping and its breakdown of idle gaps."""

from __future__ import annotations

import asyncio
import gc
import json
import sys
import threading
import time
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import tpudfs_torch.common
from portbench import harness, program_trace
from portbench.trace import WINDOW, DeviceTrace, clock
from tpudfs_torch.client.local import LocalClient
from tpudfs_torch.common import layout, trace
from tpudfs_torch.common.checksum import CHECKSUM_CHUNK_SIZE, crc32c
from tpudfs_torch.gpu import checkpoint
from tpudfs_torch.gpu.hbm_reader import HbmReader
from tpudfs_torch.gpu.infeed import DfsInfeed

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
BLOCK = 4096


class Sink:
    def __init__(self):
        self.items = []

    def add(self, *span):
        self.items.append(span)


@pytest.fixture
def sink():
    """A list sink installed for the test; whatever was installed before
    is put back."""
    before = trace._sink
    s = Sink()
    trace.install(s)
    try:
        yield s
    finally:
        trace.install(before)


def _tree() -> dict:
    g = torch.Generator().manual_seed(7)
    return {"m/bf16": torch.randn(3001, generator=g).to(torch.bfloat16),
            "opt/f4": torch.randn(5000, generator=g),
            "step": torch.tensor(12, dtype=torch.int64)}


def _shard(tmp_path, cold: bool):
    """A shard laid out as the manager saves it; ``cold``: its hot copy's
    replicas are on no store and shard 0 of every cold block is lost, so
    the restore falls back and rebuilds every block."""
    tree = _tree()
    payload, specs = checkpoint.pack_shard(tree)
    stores, metas = chip_smoke.lay_out_shard(
        tmp_path, np.frombuffer(payload, dtype=np.uint8), block_size=BLOCK,
        hot="/c/hot", cold="/c/ec")
    client = LocalClient(stores, metas)
    if cold:
        for b in metas["/c/hot"]["blocks"]:
            b["locations"] = ["gone:1"]
        chip_smoke._drop_shards(client, metas["/c/ec"], (0,))
    spec = {"shard": 0, "path": "/c/hot", "ec_path": "/c/ec",
            "size": len(payload), "crc32c": crc32c(payload),
            "tensors": [s.to_dict() for s in specs]}
    return client, spec, metas


def _restore(client, spec, stage=None):
    return asyncio.run(checkpoint.restore_shard_device(
        HbmReader(client, [CPU]), client, spec, CPU,
        {"degraded_shard_reads": 0}, stage_s=stage))


def _infeed(tmp_path) -> list:
    addrs, stores, handles = layout.stores(tmp_path, 3)
    rng = np.random.default_rng(3)
    metas = {}
    for f, size in enumerate((3 * BLOCK, 2 * BLOCK + 100)):
        path = f"/d/{f}"
        metas[path] = layout.write_replicated(
            handles, addrs, path,
            rng.integers(0, 256, size, dtype=np.uint8), BLOCK)
    infeed = DfsInfeed(LocalClient(stores, metas), sorted(metas), [CPU])
    return list(infeed.as_sync_iterator())


#: The spans each read gives, and the parents each may have.
PARENTS = {
    "restore.read": {None}, "restore.combined_crc": {None},
    "restore.assemble": {None}, "restore.bounce": {None},
    "restore.bounce_copy": {"restore.bounce"},
    "restore.bounce_crc": {"restore.bounce"},
    "reader.block": {"restore.read", "infeed.file"},
    "store.pread": {"reader.block", "ec.read_shards"},
    "reader.grid": {"store.pread"},
    "reader.h2d": {"reader.block", "ec.upload"},
    "reader.verify": {"reader.block"},
    "ec.read_shards": {"reader.block"},
    "ec.stack": {"reader.block"}, "ec.upload": {"reader.block"},
    "ec.decode": {"reader.block"},
    "infeed.file": {None}, "infeed.put_wait": {None},
    "infeed.get_wait": {None},
}
RESTORE = {"restore.read", "restore.combined_crc", "restore.assemble",
           "restore.bounce", "restore.bounce_copy", "restore.bounce_crc",
           "reader.block", "store.pread", "reader.h2d", "reader.verify"}
SPANS = {
    "hot": RESTORE | {"reader.grid"},
    "cold": RESTORE | {"ec.read_shards", "ec.stack", "ec.upload",
                       "ec.decode"},
    "infeed": {"infeed.file", "infeed.put_wait", "infeed.get_wait",
               "reader.block", "store.pread", "reader.grid", "reader.h2d",
               "reader.verify"},
}


def _read(kind, tmp_path):
    if kind == "infeed":
        return _infeed(tmp_path)
    client, spec, _metas = _shard(tmp_path, kind == "cold")
    return _restore(client, spec)


def test_off_records_nothing_and_is_one_object(tmp_path):
    before = trace._sink
    s = Sink()
    trace.install(s)
    trace.uninstall()
    try:
        assert trace.span("a") is trace.span("b", 9) is trace.OFF
        with trace.span("a") as sp:
            sp.nbytes = 5
            sp.phase("a.b")
        _read("cold", tmp_path)
        assert s.items == []
    finally:
        trace.install(before)


@pytest.mark.parametrize("kind", sorted(SPANS))
def test_every_span_nested_in_its_parent(tmp_path, sink, kind):
    _read(kind, tmp_path)
    spans = sink.items
    assert {s[0] for s in spans} == SPANS[kind]
    by_id = {s[4]: s for s in spans}
    assert len(by_id) == len(spans)
    for name, t0, t1, nbytes, _id, parent, thread in spans:
        assert t0 <= t1 and nbytes >= 0
        up = by_id.get(parent)
        assert (up[0] if up else None) in PARENTS[name], name
        if up:
            assert up[1] <= t0 and t1 <= up[2], (name, up[0])
    # The pread ran in a worker thread, parented by the block it reads.
    threads = {s[0]: s[6] for s in spans}
    assert threads["reader.block"] is None
    assert threads["store.pread"] not in (None, threading.get_ident())
    for name in ("reader.block", "reader.h2d", "store.pread"):
        assert max(s[3] for s in spans if s[0] == name) > 0, name


@pytest.mark.parametrize("cold", [False, True])
def test_stage_s_is_the_restore_spans(tmp_path, sink, cold):
    client, spec, _metas = _shard(tmp_path, cold)
    stage = {}
    _restore(client, spec, stage)
    for key, seconds in stage.items():
        want = 0.0
        for s in sink.items:
            if s[0] == f"restore.{key}":
                want += s[2] - s[1]
        assert seconds == want, key
    assert stage["bounce"] == pytest.approx(stage["bounce_copy"]
                                            + stage["bounce_crc"])
    assert len([s for s in sink.items if s[0] == "restore.read"]) == \
        1 + cold


@pytest.mark.parametrize("cold", [False, True])
def test_upload_counters_are_the_bytes_uploaded(tmp_path, sink, cold):
    client, spec, metas = _shard(tmp_path, cold)
    before = trace.counts()
    _restore(client, spec)
    after = trace.counts()
    moved = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("h2d.pageable_bytes", "h2d.pinned_bytes")}
    # The blocks alone: the tensors that are not 4-byte words stay on the
    # device, as views checked by their own CRC.
    if cold:
        # Each block's three rows, one a shard padded to the decoder's
        # width, or its chunk grid where that is longer.
        from tpudfs_torch.gpu.hbm_reader import padded_len
        from tpudfs_torch.gpu.rs_cuda import pad_shard_len
        blocks = sum(max(3 * pad_shard_len(-(-b["size"] // 3)),
                         padded_len(b["size"]))
                     for b in metas["/c/ec"]["blocks"])
    else:
        blocks = sum(-(-b["size"] // CHECKSUM_CHUNK_SIZE) * CHECKSUM_CHUNK_SIZE
                     for b in metas["/c/hot"]["blocks"])
    assert moved == {"h2d.pageable_bytes": blocks, "h2d.pinned_bytes": 0}
    assert moved["h2d.pageable_bytes"] == sum(
        s[3] for s in sink.items if s[0] == "reader.h2d")


@pytest.mark.parametrize("cold", [False, True])
def test_tensor_crc_counters_are_the_non_word_bytes(tmp_path, cold):
    """``restore.tensor_crc_bytes`` counts the bytes of the tensors checked
    by their own CRC (the bf16 weights and the int64 step), with no sink
    installed; ``restore.tensor_clones`` counts none."""
    client, spec, _metas = _shard(tmp_path, cold)
    before = trace.counts()
    _restore(client, spec)
    after = trace.counts()
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("restore.tensor_crc_bytes",
                      "restore.tensor_clones")} == {
        "restore.tensor_crc_bytes": 3001 * 2 + 8,
        "restore.tensor_clones": 0}


def test_degraded_restore_frees_its_tensors_without_the_collector(tmp_path):
    client, spec, _metas = _shard(tmp_path, cold=True)
    _restore(client, spec)  # warm: imports and tables outside the count
    gc.collect()
    gc.disable()
    try:
        out = _restore(client, spec)
        refs = [weakref.ref(t) for t in out.values()]
        del out
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


# ------------------------------------------------------------- the readers

NEW_METRICS = ["store.pread_gbps.restore", "store.pread_gbps.infeed",
               "reader.wait_share.restore", "reader.wait_share.infeed",
               "reader.pageable_share.restore",
               "reader.pageable_share.infeed", "reader.inflight.infeed",
               "ec.host_ms_per_block.restore", "ec.host_ms_per_block.ec63"]


class _Ctx:
    window = (-2.0, -1.0)


@pytest.mark.parametrize("tracer", [True, False])
@pytest.mark.parametrize("name", NEW_METRICS)
def test_reader_reads_nothing_without_its_spans(monkeypatch, name, tracer):
    before = trace._sink
    if not tracer:  # a checkout of the port from before its tracer
        monkeypatch.setattr(program_trace, "_recorder", None)
        monkeypatch.delattr(tpudfs_torch.common, "trace")
        monkeypatch.setitem(sys.modules, "tpudfs_torch.common.trace", None)
    try:
        read = harness.load_reader(name)
        assert read(_Ctx()) is None
    finally:
        trace.install(before)


def test_new_metrics_are_declared():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW_METRICS:
        cells = entries[name]["workloads"]
        assert entries[name]["source"] in ("program_span", "program_counter")
        assert ("unet3d-read" in cells) == name.endswith(".infeed")


def _s(name, t0, t1, nbytes=0, id_=0, parent=0, thread=1):
    return (name, t0, t1, nbytes, id_, parent, thread)


SPANS_A = [
    _s("reader.block", 0.0, 4.0, 8, 1, thread=None),
    _s("store.pread", 1.0, 3.0, 2e9, 2, 1),
    _s("reader.grid", 1.0, 2.0, 0, 3, 2),
    _s("reader.block", 2.0, 6.0, 8, 4, thread=None),
    _s("store.pread", 2.5, 3.5, 1e9, 5, 4),
    _s("reader.h2d", 4.0, 5.0, 0, 6, 4),
    _s("ec.stack", 1.0, 1.5, 0, 7, 1), _s("ec.upload", 1.5, 2.0, 0, 8, 1),
    _s("ec.decode", 2.0, 2.5, 0, 9, 1), _s("ec.stack", 3.0, 3.2, 0, 10, 4),
]


@pytest.mark.parametrize("fn,window,want", [
    # preads' own time: [2, 3] and [2.5, 3.5] → 1.5 s for 3 GB.
    (program_trace.pread_gbps, (0.0, 10.0), 2.0),
    (program_trace.pread_gbps, (5.0, 10.0), None),
    # Block 1: 4 s, children cover [1, 3] → 2 s idle; block 4: 4 s,
    # children [2.5, 3.5] (with [3, 3.2] inside) and [4, 5] → 2 s idle.
    (program_trace.wait_share, (0.0, 10.0), 50.0),
    # 8 s of blocks open over a 10 s window; 3 + 2 s of them in [1, 4].
    (program_trace.inflight, (0.0, 10.0), 0.8),
    (program_trace.inflight, (1.0, 4.0), 5.0 / 3.0),
    # Block 1 rebuilt (1.5 s of EC steps); block 4 only stacked.
    (program_trace.ec_host_ms_per_block, (0.0, 10.0), 1500.0),
    (program_trace.ec_host_ms_per_block, (2.9, 10.0), None),
])
def test_reader_arithmetic(fn, window, want):
    assert fn(SPANS_A, window) == pytest.approx(want) if want is not None \
        else fn(SPANS_A, window) is None


@pytest.mark.parametrize("uploads,want", [
    ([(0.5, 10, 0), (2.0, 40, 0), (3.0, 70, 30)], 60 / 90 * 100),
    ([(2.0, 40, 0)], None),
    ([(0.5, 10, 0), (2.0, 10, 0)], None),
    ([(0.5, 10, 5), (9.0, 90, 5)], 100.0),
])
def test_pageable_share(uploads, want):
    assert program_trace.pageable_share(uploads, (1.0, 10.0)) == want


def test_breakdown_two_threads_and_many_open_spans():
    """Gaps [1, 3], [4, 6] and [7, 9] s; 100 awaiting blocks open over all
    of them, which the harness's old look-back of 64 spans could not see
    past. [1, 3] is cut where its spans begin and end: the blocks wait in
    [1, 1.5] and [2.5, 3]; one thread preads, then fills its grid, while
    another uploads in [1.8, 2.2]."""
    ops = [("k", "kernel", s, s + 1.0, None) for s in (0.0, 3.0, 6.0, 9.0)]
    device = DeviceTrace(ops, (0.0, 10.0))
    program = [_s("reader.block", 0.5 + i / 1000, 9.5, 1, 100 + i,
                  thread=None) for i in range(100)]
    program += [_s("store.pread", 1.5, 2.5, 1, 1, thread=11),
                _s("reader.grid", 1.6, 2.4, 1, 2, 1, thread=11),
                _s("reader.h2d", 1.8, 2.2, 1, 3, thread=12),
                _s("reader.verify", 4.5, 5.5, 0, 4, thread=None)]
    harness_spans = [("restore", 0.0, 10.0, 0)]
    got = dict(map(tuple, program_trace.breakdown(
        device, program, harness_spans)["idle_gaps"]))
    assert got == pytest.approx({"reader.block": 1.0 + 1.0 + 2.0,
                                 "store.pread": 0.2, "reader.grid": 0.6,
                                 "reader.h2d": 0.2, "reader.verify": 1.0})


def test_breakdown_falls_back_to_harness_spans_then_outside():
    ops = [("k", "kernel", s, s + 1.0, None) for s in (0.0, 3.0, 6.0, 9.0)]
    device = DeviceTrace(ops, (0.0, 10.0))
    # 100 short store spans closed before 5 s, after the step's start: the
    # old look-back reads only them and misses the step open around 5 s.
    harness_spans = [("restore", 0.0, 7.5, 0)] + [
        ("store.read_block", 3.0 + i / 1000, 3.5, 0) for i in range(100)]
    got = dict(map(tuple, program_trace.breakdown(
        device, [], harness_spans)["idle_gaps"]))
    assert got == pytest.approx({"restore": 4.5, program_trace.OUTSIDE: 1.5})
    old = dict(map(tuple, device.breakdown(harness_spans)["idle_gaps"]))
    assert old[program_trace.OUTSIDE] == pytest.approx(4.0)


def test_two_point_mapping_puts_a_range_inside_its_span(tmp_path, sink):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the profiler's first range is slow
            pass
        with record_function(WINDOW):
            anchor = clock()
            time.sleep(0.005)
            with trace.span("outer"):
                time.sleep(0.005)
                with record_function("inner"):
                    time.sleep(0.005)
                time.sleep(0.005)
            time.sleep(0.005)
            end = clock()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    for e in events:  # the range stands in for a device operation
        if e.get("name") == "inner" and e.get("ph") == "X":
            e["cat"] = "kernel"
    device, skew_us = program_trace.two_point(
        DeviceTrace.from_events(events, anchor), end)
    (_n, _c, s, e, _b), = device.ops
    (_name, t0, t1, *_rest), = sink.items
    assert t0 < s < e < t1
    assert device.window == (anchor, end) and abs(skew_us) < 1e3
