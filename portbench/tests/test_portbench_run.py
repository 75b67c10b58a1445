"""A whole run of each kind of cell on the CPU at a small size (the
program's plain twins stand for its kernels): the result line, the
references against the program, and `correct` coming out false when the
timed path is broken underneath or when the lower-precision control takes
the program's place."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import control, run
from portbench.harness import registry
from portbench.reference import sort as ref_sort
from portbench.reference import walk as ref_walk

SORT_CELL = "sort_ygs.hprc90_mhc"
SORT_SMALL = dict(n_haps=16, locus_len=300_000)

# The walk cells are held back from BENCHMARK.json (PERF.md §7); their
# driver and references stay tested on a small index of the scale tier's
# yeast-shaped draw.
YEAST_SMALL = dict(
    name="yeast_small", alignments="yeast_ava", n_seqs=60, seq_len=60_000,
    n_aln=3000, chunks=3, tail_frac=0.2, match_bp=[30, 180], edit_bp_max=6,
    edit_pairs_per_kb=9.2, body_median_at_580kb=4900.0, body_sigma=1.6,
    max_aln_share=0.98, reverse_share=0.3)
WALK_CELLS = ("query_x.yeast_small", "query_x_approx.yeast_small")


def walk_spec(config_file: str) -> dict:
    spec = registry.benchmark()
    spec["configs"].append({"name": "yeast_small", "file": config_file})
    for name in WALK_CELLS:
        spec["workloads"].append({"name": name, "config": "yeast_small",
                                  "traffic": name.split(".")[0], "chips": 1})
    spec["end_to_end"].append({"name": "seeds_per_s", "unit": "seeds/s",
                               "workloads": list(WALK_CELLS)})
    return spec


@pytest.fixture(scope="session")
def yeast_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("portbench") / "yeast_small.json"
    path.write_text(json.dumps(YEAST_SMALL))
    return str(path)


def small_cell(name: str, yeast_file: str = "") -> registry.Cell:
    if name in WALK_CELLS:
        cell = registry.Cell(walk_spec(yeast_file), name)
        cell.mix["batch"] = 64
        return cell
    cell = registry.Cell(registry.benchmark(), name)
    cell.config.update(SORT_SMALL)
    # Under `auto` a graph this small sorts with the numpy loop; the device
    # backend on the CPU is K-I's plain twin.
    cell.mix["sgd_backend"] = "device"
    return cell


def small_table(name: str, seed: int, yeast_file: str
                ) -> ref_walk.DirectedTable:
    """The reference's record table of a walk cell's data at its small
    size."""
    return control.walk_table(small_cell(name, yeast_file), seed)


def cpu_run(cell, seed=2**31 + 5, seconds=1.0, traced=False):
    return run.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                        t_start=time.perf_counter())


@pytest.mark.parametrize("name", WALK_CELLS + (SORT_CELL,))
def test_result_line(name, yeast_file):
    cell = small_cell(name, yeast_file)
    res = cpu_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in res["checks"].items():
        if name == "layout_stress_ratio":
            # The program's layout is the reference's, draw for draw.
            assert c["value"] == 1.0 and c["limit"] > 1.0
        else:
            assert c["value"] == 0 and c["limit"] == 0
    json.dumps(res, allow_nan=False)


def _alter_hits(monkeypatch):
    """An answer altered where it is produced: one hit in 64 projects one
    base off."""
    from impg_tpu_torch.query import device as qdev

    inner = qdev.TorchDeviceEngine.query_batch_stream

    def broken(self, *a, **kw):
        for out in inner(self, *a, **kw):
            if out["pq_start"].size:
                out["pq_start"] = out["pq_start"].copy()
                out["pq_start"][::64] += 1
            yield out

    monkeypatch.setattr(qdev.TorchDeviceEngine, "query_batch_stream", broken)


def _half_batch(monkeypatch):
    """Half of each batch left out: its second half's walks come back
    empty."""
    from impg_tpu_torch.query import engine as engine_mod

    inner = engine_mod.query_transitive_bfs_many

    def broken(index, targets, **kw):
        h = len(targets) // 2
        cols = {f: np.zeros(0, np.int64) for f in
                ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")}
        return (inner(index, targets[:h], **kw)
                + [engine_mod.RowBlock(**cols) for _ in targets[h:]])

    monkeypatch.setattr(engine_mod, "query_transitive_bfs_many", broken)


@pytest.mark.parametrize("fault", [_alter_hits, _half_batch])
@pytest.mark.parametrize("name", WALK_CELLS)
def test_walk_fault_is_not_correct(name, fault, monkeypatch, yeast_file):
    fault(monkeypatch)
    # A few batches, so that the walks the run checks fall on both halves.
    cell = small_cell(name, yeast_file)
    res = cpu_run(cell, seconds=3.0)
    assert res["attempted"] >= 2 * cell.mix["batch"]
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0


def _layout_unchanged(monkeypatch):
    """A step that returns its state unchanged: the layout hands back its
    start positions."""
    from impg_tpu_torch.ops import path_sgd

    monkeypatch.setattr(path_sgd, "sgd_epochs",
                        lambda x0, *a, **kw: np.asarray(x0, np.float64))


def _no_layout(monkeypatch):
    """The sort skips its layout: Y keeps the input's order."""
    from impg_tpu_torch.graph import sortgfa

    monkeypatch.setattr(sortgfa, "sgd_order_columns",
                        lambda gc, **kw: np.arange(gc.n_segs))


def _alter_segment(monkeypatch):
    """An answer altered where it is produced: one base of the sorted
    graph's first segment changed."""
    from impg_tpu_torch.graph import sortgfa

    inner = sortgfa.sort_pipeline

    def broken(*a, **kw):
        out = inner(*a, **kw)
        at = out.index("\nS\t") + 1
        tab = out.index("\t", at + 2) + 1
        base = "C" if out[tab] != "C" else "G"
        return out[:tab] + base + out[tab + 1:]

    monkeypatch.setattr(sortgfa, "sort_pipeline", broken)


def _order_ignored(monkeypatch):
    """The sorted graph lists its segments in another order than its own
    layout gives: the topological sort takes the input's order for
    priority."""
    from impg_tpu_torch.graph import sortgfa

    inner = sortgfa.sgd_order_columns

    def broken(gc, **kw):
        inner(gc, **kw)
        return np.arange(gc.n_segs)

    monkeypatch.setattr(sortgfa, "sgd_order_columns", broken)


@pytest.mark.parametrize("fault", [_layout_unchanged, _no_layout,
                                   _alter_segment, _order_ignored])
def test_sort_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res = cpu_run(small_cell(SORT_CELL))
    assert res["correct"] is False
    json.dumps(res, allow_nan=False)


def _small_graph(seed: int) -> ref_sort.Graph:
    c = small_cell(SORT_CELL).config
    return ref_sort.Graph(registry.load_file("datagen", "panel_gfa").make(
        c, seed, "")["gfa"])


@pytest.mark.parametrize("seed", [9, 2**31 + 11])
def test_sort_control_fails(seed):
    """A layout held in bfloat16, in the program's place, reads a stress
    far above the limit."""
    from portbench.drivers.sort import STRESS_RATIO_LIMIT

    g = _small_graph(seed)
    pairs = ref_sort.stress_pairs(g, seed)
    exact = ref_sort.stress(ref_sort.layout_positions(g, 30, 8, "cpu"),
                            pairs)
    low = ref_sort.layout_positions(g, 30, 8, "cpu",
                                    position_dtype=torch.bfloat16)
    assert ref_sort.stress(low, pairs) > 10 * STRESS_RATIO_LIMIT * exact


def test_another_sound_layout_is_correct(monkeypatch):
    """A layout from another stream of draws, sound but not the program's,
    passes: the check does not freeze the program's sampler."""
    from impg_tpu_torch.ops import path_sgd

    cell = small_cell(SORT_CELL)
    text = cell.datagen("graph").make(cell.config, 2**31 + 5, "")["gfa"]
    other = ref_sort.layout_positions(ref_sort.Graph(text), 30, 8, "cpu",
                                      key=43)
    inner = path_sgd.sgd_epochs

    def other_stream(*a, **kw):
        inner(*a, **kw)
        return other.copy()

    monkeypatch.setattr(path_sgd, "sgd_epochs", other_stream)
    res = cpu_run(cell)
    assert res["correct"] is True
    assert 1.0 != res["checks"]["layout_stress_ratio"]["value"] < 1.2


@pytest.mark.parametrize("name", WALK_CELLS)
def test_walk_control_fails(name, yeast_file):
    """The reference in bfloat16 coordinates, in the program's place,
    misses the exact reference."""
    table = small_table(name, 11, yeast_file)
    kw = registry.load_file("drivers", "walk").reference_args(
        small_cell(name, yeast_file).mix)
    rng = np.random.default_rng(4)
    off = 0
    for _ in range(4):
        sid = int(rng.integers(len(table.names)))
        s = int(rng.integers(0, int(table.lengths[sid]) - 20_000))
        exact = table.walk(sid, s, s + 20_000, **kw)
        assert exact.shape[0] > 1
        off += ref_walk.rows_off(table.walk(sid, s, s + 20_000,
                                            coord="bf16", **kw), exact)
    assert off > 0


def test_walk_reference_equals_host_engine(yeast_file):
    """The plain reference walk and the program's own host walk agree row
    for row."""
    from impg_tpu_torch.query import engine as engine_mod

    cell = small_cell("query_x.yeast_small", yeast_file)
    data = cell.datagen("alignments").make(cell.config, 21, "/nonexistent")
    table = ref_walk.DirectedTable(data["chunks"], data["names"],
                                   data["lengths"])
    rng = np.random.default_rng(8)
    targets = []
    for _ in range(16):
        sid = int(rng.integers(60))
        s = int(rng.integers(0, 30_000))
        targets.append((sid, s, s + 10_000))
    blocks = engine_mod.query_transitive_bfs_many(data["index"], targets,
                                                  columnar=True)
    for (t, s, e), b in zip(targets, blocks):
        got = np.stack([b.q_id, b.q_first, b.q_last, b.t_id, b.t_first,
                        b.t_last], 1).astype(np.int64)
        assert ref_walk.rows_off(got, table.walk(t, s, e)) == 0


def test_traced_run_without_device_events_fails():
    """On the CPU the profiler records no device event: a traced run must
    fail rather than read a card 100% idle."""
    from portbench.harness.trace import EmptyTrace

    with pytest.raises(EmptyTrace):
        cpu_run(small_cell(SORT_CELL), traced=True)


def test_no_blocked_import_in_a_run():
    """A whole run in a fresh interpreter, with jax and impg_tpu refused,
    leaves neither (nor jaxlib or flax) in sys.modules by whole top-level
    name."""
    code = f"""
import sys, time, json
sys.path.insert(0, {registry.ROOT!r})
from portbench.harness import guard
g = guard.ImportGuard().install()
import torch
sys.path.insert(0, {os.path.dirname(__file__)!r})
from test_portbench_run import small_cell, cpu_run
res = cpu_run(small_cell("sort_ygs.hprc90_mhc"))
print(json.dumps(dict(correct=res["correct"], blocked=guard.loaded_blocked(),
                      tried=g.tried,
                      port=[m for m in sys.modules
                            if m.split(".")[0] == "impg_tpu_torch"][:1])))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert got["blocked"] == [] and got["tried"] == []
    assert got["port"]  # the run did load the port


def test_references_import_nothing_of_the_program():
    code = f"""
import sys, json
sys.path.insert(0, {registry.ROOT!r})
import portbench.reference.walk, portbench.reference.sort
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"impg_tpu_torch", "impg_tpu", "jax", "jaxlib",
                       "flax"}


def test_guard_compares_whole_top_level_names():
    from portbench.harness import guard

    assert guard.is_blocked("impg_tpu") and guard.is_blocked("impg_tpu.cli")
    assert guard.is_blocked("jax.numpy") and guard.is_blocked("jaxlib")
    assert not guard.is_blocked("impg_tpu_torch")
    assert not guard.is_blocked("impg_tpu_torch.query.engine")
    assert not guard.is_blocked("jaxtyping")
    assert guard.loaded_blocked({"impg_tpu_torch": sys, "flax.core": sys,
                                 "jax": None}) == ["flax.core"]


def test_run_exits_without_a_card():
    """No CUDA: the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         SORT_CELL, "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=registry.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_one_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         SORT_CELL, "--seed", "77", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=registry.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
