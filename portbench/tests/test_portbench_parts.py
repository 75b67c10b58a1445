"""BENCHMARK.json and the files the harness finds by name; the roofline
counts at fixed shapes; the trace reduction."""

import json
import os
import re

import numpy as np
import pytest

from portbench.harness import peaks, registry
from portbench.harness.trace import DeviceTrace, EmptyTrace, merge_intervals

SPEC = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        cell = registry.Cell(SPEC, w["name"])
        assert cell.driver().__name__.endswith(cell.mix["driver"])
        for role in ("alignments", "graph"):
            if role in cell.config:
                assert hasattr(cell.datagen(role), "make")
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)


def test_every_metric_has_its_reader():
    for m in SPEC["per_layer"]:
        assert callable(registry.load_file("layers", m["name"]).read)


def test_names_and_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"])
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in cells
            assert registry.applies(moved, c), (m["name"], c)
    for c in SPEC["configs"]:
        path = os.path.join(registry.ROOT, c["file"])
        assert registry.read_json(path)["name"] == c["name"]


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        registry.Cell(SPEC, "no_such.cell")


def test_json_is_small_and_plain():
    text = open(os.path.join(registry.ROOT, "BENCHMARK.json")).read()
    assert len(text.encode()) <= 64 * 1024
    assert set(json.loads(text)) == {"command", "paths", "run_seconds",
                                     "configs", "workloads", "end_to_end",
                                     "per_layer"}


def test_lane_roofline_counts():
    kc = registry.load_file("roofline", "project_lanes")
    kd = registry.load_file("roofline", "compact")
    ke = registry.load_file("roofline", "project_approx")
    # 3,909,739 lanes of 24,156 queries, 1,000,000 listed, 300,000 hits of
    # 6 fields.
    assert kc.work(3_909_739, 24_156, 1_000_000, 300_000, 6) == (
        3_909_739 * 9 + 24_156 * 20 + 1_000_000 * 56 + 300_000 * 24, 0.0)
    assert ke.work(3_909_739, 24_156, 1_000_000, 300_000, 6) == (
        3_909_739 * 9 + 24_156 * 20 + 1_000_000 * 52 + 300_000 * 24, 0.0)
    assert kd.work(3_909_739, 300_000, 6) == (
        3_909_739 + 2 * 300_000 * 24, 0.0)
    # 1e9 bytes at 3.35 TB/s.
    assert peaks.least_seconds(1e9) == pytest.approx(1e9 / 3.35e12)


def test_path_sgd_roofline_counts():
    ki = registry.load_file("roofline", "path_sgd")
    n_bytes, n_ops = ki.epoch_work(11_900_000, 196_000, 8 * 11_900_000)
    assert ki.OPS_PER_SAMPLE == 186
    assert n_ops == 8 * 11_900_000 * 186
    assert n_bytes == 11_900_000 * 16 + 196_000 * 44
    # Bound by operations: 1.77e10 / 67e12 s.
    assert peaks.least_seconds(n_bytes, n_ops) == pytest.approx(
        n_ops / 67e12)


def test_windows_census():
    from portbench.reference.walk import DirectedTable

    # One sequence, records at [0,10) [5,30) [20,25) [40,50), one chunk of
    # single-run alignments to a second sequence.
    ts = np.array([0, 5, 20, 40])
    te = np.array([10, 30, 25, 50])
    ch = dict(query_id=np.ones(4, np.int64), target_id=np.zeros(4, np.int64),
              t_start=ts, t_end=te, q_start=ts, q_end=te,
              strand=np.zeros(4, np.int64),
              runs=(te - ts).astype(np.uint32),
              run_offsets=np.arange(5, dtype=np.int64))
    table = DirectedTable([ch], ["a", "b"], [100, 100])
    win = registry.load_file("roofline", "windows")
    # [26, 35): records from the first whose running max end reaches 26
    # ([5,30)) to the last starting at or before 35 ([20,25)): 2 lanes, one
    # listed.  [0, 100) on sequence a: all 4 listed.
    assert win.census(table, [0], [26], [35]) == (2, 1)
    assert win.census(table, [0, 0], [26, 0], [35, 100]) == (6, 5)


def test_trace_union_and_empty():
    assert merge_intervals([[5, 7], [0, 2], [1, 3], [6, 9]]) == [[0, 3],
                                                                  [5, 9]]
    tr = DeviceTrace([(0, 2e5, "k1"), (1e5, 3e5, "k2"), (5e5, 6e5, "k1")],
                     [(0, 1e6, "walk_batch"), (3e5, 5e5, "engine_stream")],
                     window_s=1.0)
    assert tr.busy_s == pytest.approx(0.4)
    assert tr.idle_share() == pytest.approx(0.6)
    assert tr.kernel_seconds("k1") == (pytest.approx(0.3), 2)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(0.3)]
    assert b["idle_gaps"] == [["engine_stream", pytest.approx(0.2)]]
    with pytest.raises(EmptyTrace):
        DeviceTrace([], [], window_s=1.0)
