"""impg_tpu_torch/tracing.py and the spans of the sort path, on the CPU.

Off, a sort records no span and never opens a profiler range; `enable()`
gives nested spans whose self time is their total less their children's;
under a CPU torch.profiler every stage of `sort_pipeline` is one span a
sort, and the stages that launch no device work are profiler ranges named
"impg.<span>"; the sorted bytes do not depend on the spans; the kernels'
launch counts and the copies' byte counts are tracing's counters; the raw
spans kept are bounded while the totals stay exact; the layout's entry
stays a module attribute looked up at each call; and `sort -v 1` logs the
spans at exit, `-v 0` none."""

import os
import subprocess
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from impg_tpu_torch import kernels, synth, tracing
from impg_tpu_torch.graph import gfa_columns, sortgfa
from impg_tpu_torch.ops import path_sgd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAPH = synth.variation_graph(seed=3, n_haps=4, locus_len=10_000)
BACKENDS = ("numpy", "device")
# The sort's span tree: each span and its parent.
TREE = {
    "sort": None, "sort.parse": "sort", "sort.layout": "sort",
    "layout.inputs": "sort.layout", "layout.setup": "sort.layout",
    "layout.pack": "sort.layout", "layout.upload": "sort.layout",
    "layout.epochs": "sort.layout", "layout.readback": "sort.layout",
    "layout.order": "sort.layout", "sort.reorder": "sort",
    "sort.groom": "sort", "sort.topo": "sort", "sort.write": "sort",
}
# Spans around device work: kept in memory, never a profiler range.
LAUNCHING = {"sort", "sort.layout", "layout.upload", "layout.epochs",
             "layout.readback"}
# Spans the numpy backend does not run (its layout has no device copies).
DEVICE_ONLY = {"layout.pack", "layout.upload", "layout.readback"}


@pytest.fixture(autouse=True)
def clean_tracing():
    """Spans off and nothing recorded around each test; one torch thread,
    so that test workers sharing the cores do not starve each other in
    K-I's twin."""
    was = tracing.enable(False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.reset()
    yield
    torch.set_num_threads(threads)
    tracing.enable(was)
    tracing.reset()


def sort(backend: str) -> str:
    return sortgfa.sort_pipeline(GRAPH, "Ygs", sgd_backend=backend,
                                 device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
def test_off_records_nothing_and_opens_no_range(backend, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with spans off")

    monkeypatch.setattr(tracing, "record_function", refuse)
    sort(backend)
    assert tracing.totals() == {} and tracing.records() == []
    assert tracing.span("a") is tracing.span("b")


def test_nested_spans_self_time(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(tracing, "perf_counter_ns", lambda: next(ticks))
    tracing.enable()
    with tracing.span("outer"):            # 0 .. 50
        with tracing.span("inner"):        # 10 .. 20
            pass
        with tracing.span("inner"):        # 30 .. 40
            pass
    with tracing.span("outer"):            # 60 .. 70
        pass
    tot = tracing.totals()
    assert tot["inner"] == {"calls": 2, "total_ns": 20, "self_ns": 20}
    assert tot["outer"] == {"calls": 2, "total_ns": 60, "self_ns": 40}
    assert [(r.name, r.parent, r.start_ns, r.end_ns)
            for r in tracing.records()] == [
        ("inner", "outer", 10, 20), ("inner", "outer", 30, 40),
        ("outer", None, 0, 50), ("outer", None, 60, 70)]


def test_records_bounded_totals_exact(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 3)
    tracing.enable()
    for _ in range(5):
        with tracing.span("s"):
            pass
    assert len(tracing.records()) == 3 and tracing.dropped() == 2
    assert tracing.totals()["s"]["calls"] == 5
    tracing.reset()
    assert tracing.records() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_profiled_sort_records_the_tree(backend):
    """A profiler turns the spans on with no change to the caller: two
    sorts give each span of the tree twice, under its parent, and the
    spans that launch no device work are profiler ranges."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sort(backend)
        sort(backend)
    want = set(TREE) - (DEVICE_ONLY if backend == "numpy" else set())
    tot = tracing.totals()
    assert set(tot) == want
    assert all(t["calls"] == 2 for t in tot.values())
    assert {(r.name, r.parent) for r in tracing.records()} == {
        (n, TREE[n]) for n in want}
    for t in tot.values():
        assert 0 <= t["self_ns"] <= t["total_ns"]
    children = sum(tot[n]["total_ns"] for n in want if TREE[n] == "sort")
    assert tot["sort"]["self_ns"] == tot["sort"]["total_ns"] - children
    ranges = {e.name for e in prof.events()
              if e.name.startswith(tracing.PREFIX)}
    # The numpy backend's epochs run on the host: a profiler range.
    host = want - LAUNCHING | ({"layout.epochs"} if backend == "numpy"
                               else set())
    assert ranges == {tracing.PREFIX + n for n in host}
    assert {"impg.sort.parse", "impg.sort.write"} <= ranges
    # Outside the profiler the spans are off again.
    sort(backend)
    assert tracing.totals()["sort"]["calls"] == 2


@pytest.mark.parametrize("mode", ["enable", "profile"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_sorted_bytes_do_not_depend_on_spans(backend, mode):
    off = sort(backend)
    if mode == "enable":
        tracing.enable()
        on = sort(backend)
    else:
        with profile(activities=[ProfilerActivity.CPU]):
            on = sort(backend)
    assert tracing.totals()["sort"]["calls"] == 1
    assert on == off


def test_layout_counts_its_bytes():
    """The layout's uploads (steps, positions) and its read back are
    counted in bytes, spans on or off."""
    sort("device")
    gc = gfa_columns.parse_gfa_columns(GRAPH)
    n_steps = int(gc.step_name_idx.size)
    assert tracing.counters() == {
        "xfer.h2d_bytes": 16 * n_steps + 4 * gc.n_segs,
        "layout.d2h_bytes": 4 * gc.n_segs}


class _Launches:
    """Every entry point launches (returns 0)."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_launch_counts_are_counters(monkeypatch):
    monkeypatch.setattr(kernels, "_lib", _Launches())
    kernels.reset_launch_counts()
    tracing.count("xfer.h2d_bytes", 8)
    for _ in range(3):
        kernels.launch("path_sgd", "impg_path_sgd_epoch")
    kernels.launch("compact", "impg_compact")
    assert tracing.counters() == {"launch.path_sgd": 3, "launch.compact": 1,
                                  "xfer.h2d_bytes": 8}
    counts = kernels.launch_counts()
    assert counts.pop("path_sgd") == 3 and counts.pop("compact") == 1
    assert counts == dict.fromkeys(counts, 0)
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)
    assert tracing.counters() == {"xfer.h2d_bytes": 8}


def test_layout_entry_is_looked_up_at_call_time(monkeypatch):
    """sortgfa calls ops/path_sgd.sgd_epochs through the module, so a
    wrapper set there sees every device layout."""
    calls = []
    inner = path_sgd.sgd_epochs

    def wrapper(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)

    monkeypatch.setattr(path_sgd, "sgd_epochs", wrapper)
    tracing.enable()
    sort("device")
    assert calls == [1]
    assert tracing.totals()["layout.readback"]["calls"] == 1


@pytest.mark.parametrize("verbosity", ["0", "1"])
def test_cli_logs_spans_at_info(verbosity, tmp_path):
    gfa = tmp_path / "g.gfa"
    gfa.write_text(GRAPH)
    out = subprocess.run(
        [sys.executable, "-m", "impg_tpu_torch.cli", "-v", verbosity, "sort",
         str(gfa), "--sgd-backend", "numpy", "--output",
         str(tmp_path / "out.gfa")],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "out.gfa").read_text() == sort("numpy")
    logged = [line for line in out.stderr.splitlines()
              if "impg_tpu_torch.tracing" in line]
    if verbosity == "0":
        assert logged == []
    else:
        text = "\n".join(logged)
        for name in ("sort.parse", "sort.write", "layout.epochs"):
            assert f"span {name}: 1 calls," in text

