"""The readers of the program's own spans (layers/sort_parse_ms.py,
layout_prep_ms.py, sort_groom_topo_ms.py, sort_write_ms.py,
layout_wait_ms.py): ms a graph from the span totals over the calls of
`sort`; None where the program has no tracing module (a parent commit
without it) or recorded no sort; and, over sorts profiled on the CPU, the
five with the upload and the epochs account for the sorts' time."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.harness import registry

READERS = {
    "sort_parse_ms": ("sort.parse",),
    "layout_prep_ms": ("layout.inputs", "layout.setup", "layout.pack",
                       "layout.order"),
    "sort_groom_topo_ms": ("sort.reorder", "sort.groom", "sort.topo"),
    "sort_write_ms": ("sort.write",),
    "layout_wait_ms": ("layout.readback",),
}
SORT_CELL = "sort_ygs.hprc90_mhc"


def read(name):
    return registry.load_file("layers", name).read({})


def test_each_reader_is_a_metric_of_the_sort_cell():
    spec = {m["name"]: m for m in registry.benchmark()["per_layer"]}
    for name in READERS:
        m = spec[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms/graph", "lower", "program_span", "sort_s_per_graph")
        assert m["workloads"] == [SORT_CELL]


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_from_totals(name, monkeypatch):
    from impg_tpu_torch import tracing

    names = [n for ns in READERS.values() for n in ns]
    tot = {n: {"calls": 4, "total_ns": (i + 1) * 1_000_000, "self_ns": 0}
           for i, n in enumerate(names)}
    tot["sort"] = {"calls": 4, "total_ns": 10**9, "self_ns": 0}
    tot["layout.epochs"] = {"calls": 4, "total_ns": 7 * 10**9, "self_ns": 0}
    monkeypatch.setattr(tracing, "totals", lambda: tot)
    want = sum(tot[n]["total_ns"] for n in READERS[name]) / 1e6 / 4
    assert read(name) == pytest.approx(want)
    del tot["sort"]
    assert read(name) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_tracing_module(name, monkeypatch):
    monkeypatch.setitem(sys.modules, "impg_tpu_torch.tracing", None)
    assert read(name) is None


def test_readers_account_for_profiled_sorts():
    """Two sorts of a small graph under a CPU profiler, the device backend
    on K-I's twin: the calls of `sort` are the sorts, and the five readings
    with the upload and the epochs come within 5% of the sort's time."""
    from impg_tpu_torch import synth, tracing
    from impg_tpu_torch.graph import sortgfa

    text = synth.variation_graph(seed=3, n_haps=4, locus_len=10_000)
    was = tracing.enable(False)
    tracing.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                sortgfa.sort_pipeline(text, "Ygs", sgd_backend="device",
                                      device=torch.device("cpu"))
        tot = tracing.totals()
        got = {name: read(name) for name in READERS}
    finally:
        tracing.enable(was)
        tracing.reset()
    assert tot["sort"]["calls"] == 2
    assert all(v > 0 for v in got.values())
    rest = sum(tot[n]["total_ns"] for n in ("layout.upload",
                                            "layout.epochs")) / 1e6 / 2
    whole = tot["sort"]["total_ns"] / 1e6 / 2
    assert sum(got.values()) + rest == pytest.approx(whole, rel=0.05)
