"""The query cell over a panel's all-vs-all (datagen/panel_ava.py) at a small
size of its panel: the alignments spell the sort cell's haplotypes and
follow from the sites, a whole run on the CPU reports its rate and is
correct, and `correct` comes out false when the walk is broken underneath
or when the lower-precision control takes the program's place."""

import json

import numpy as np
import pytest

from portbench import control, control_panel
from portbench.harness import registry
from portbench.harness.registry import load_file
from portbench.reference import walk as ref_walk
from test_portbench_run import _alter_hits, _half_batch, cpu_run

CELL = "query_x.hprc90_mhc_ava"
SMALL = dict(n_haps=16, locus_len=300_000)
PANEL = dict(SMALL, n_founders=2, founder_div=0.000975, hap_div=0.000025,
             graph_indel_share=0.041, graph_max_indel=3)


def small_cell() -> registry.Cell:
    cell = registry.Cell(registry.benchmark(), CELL)
    cell.config.update(SMALL)
    cell.mix["batch"] = 64
    return cell


def _panel(graph_seed):
    gen = load_file("datagen", "panel_ava")
    c = dict(PANEL, graph_seed=graph_seed)
    sites = gen.panel_sites(**gen.site_params(c))
    chunks, names, lengths = gen.reference_data(c)
    return gen, c, sites, chunks, names, lengths


def _spell(sites: dict, h: int) -> bytes:
    """Haplotype h's sequence, site by site."""
    base = sites["base"]
    parts, at = [], 0
    for k in np.flatnonzero(sites["carriers"][:, h]).tolist():
        p, ln = int(sites["pos"][k]), int(sites["length"][k])
        kind = int(sites["kind"][k])
        parts.append(base[at:p])
        if kind == 0:
            parts.append(sites["alt_base"][k:k + 1])
            at = p + 1
        elif kind == 1:
            at = p + ln
        else:
            o = int(sites["ins_off"][k])
            parts.append(sites["ins_seq"][o:o + ln])
            at = p
    parts.append(base[at:])
    return np.concatenate(parts).tobytes()


@pytest.mark.parametrize("graph_seed", [1, 2**31 + 3])
def test_panel_ava_spells_the_gfa_paths(graph_seed):
    """The all-vs-all panel is the sort cell's: each haplotype spells its P
    line of panel_gfa's graph from the same graph_seed."""
    from portbench.reference.sort import Graph

    gen, c, sites, _, names, lengths = _panel(graph_seed)
    g = Graph(load_file("datagen", "panel_gfa").make(c, 5, "")["gfa"])
    for h in range(c["n_haps"]):
        hap = _spell(sites, h)
        assert hap == g.spell(h), h
        assert len(hap) == lengths[h]
    assert names == [f"hap{h}" for h in range(c["n_haps"])]


def _apply(runs, target, query):
    """Applies one alignment's CIGAR to its target: = runs copy the target
    into the query, X runs put another base, I runs add query bases, D runs
    skip target bases, and the runs end at both ends."""
    t = np.frombuffer(target, np.uint8)
    q = np.frombuffer(query, np.uint8)
    lens = (runs & ref_walk.LEN_MASK).astype(np.int64)
    ops = (runs >> 29).astype(np.int64)
    assert (lens > 0).all()
    t_len = np.where(ops == ref_walk.OP_I, 0, lens)
    q_len = np.where(ops == ref_walk.OP_D, 0, lens)
    assert t_len.sum() == t.size and q_len.sum() == q.size
    t0 = np.cumsum(t_len) - t_len
    q0 = np.cumsum(q_len) - q_len
    eq = ops == ref_walk.OP_EQ
    within = np.arange(int(lens[eq].sum())) - np.repeat(
        np.cumsum(lens[eq]) - lens[eq], lens[eq])
    assert np.array_equal(t[np.repeat(t0[eq], lens[eq]) + within],
                          q[np.repeat(q0[eq], lens[eq]) + within])
    x = ops == ref_walk.OP_X
    assert (lens[x] == 1).all() and (t[t0[x]] != q[q0[x]]).all()


@pytest.mark.parametrize("graph_seed", [1, 2**31 + 3])
def test_panel_ava_cigars_spell_their_queries(graph_seed):
    gen, c, sites, chunks, _, lengths = _panel(graph_seed)
    haps = [_spell(sites, h) for h in range(c["n_haps"])]
    pairs = set()
    for ch in chunks:
        for a in range(ch["query_id"].size):
            i, j = int(ch["target_id"][a]), int(ch["query_id"][a])
            assert i < j and ch["strand"][a] == 0
            assert (ch["t_start"][a], ch["t_end"][a]) == (0, lengths[i])
            assert (ch["q_start"][a], ch["q_end"][a]) == (0, lengths[j])
            runs = ch["runs"][ch["run_offsets"][a]:ch["run_offsets"][a + 1]]
            _apply(runs, haps[i], haps[j])
            pairs.add((i, j))
    assert len(pairs) == c["n_haps"] * (c["n_haps"] - 1) // 2


def test_panel_ava_counts_follow_from_the_sites(tmp_path):
    """An alignment has two runs a site where its haplotypes differ and one
    more; the index holds every alignment in both directions."""
    gen, c, sites, chunks, _, _ = _panel(1)
    car = sites["carriers"]
    runs = n_aln = 0
    for ch in chunks:
        diff = (car[:, ch["target_id"]] != car[:, ch["query_id"]]).sum(0)
        assert np.array_equal(np.diff(ch["run_offsets"]), 2 * diff + 1)
        runs += ch["runs"].size
        n_aln += ch["query_id"].size
    assert n_aln == 120
    index = gen.make(c, 7, str(tmp_path))["index"]
    assert len(index.records) == 2 * n_aln
    assert index.arena.n_ops == 2 * runs
    # Across founders a pair differs at both founders' sites and both
    # haplotypes' own; within a founder at the two haplotypes' own.
    n = c["locus_len"]
    founder = n * c["founder_div"]
    own = n * c["hap_div"]
    d_across = (car[:, 0] != car[:, 1]).sum()
    d_within = (car[:, 0] != car[:, 2]).sum()
    assert abs(d_across - (2 * founder + 2 * own)) < 6 * np.sqrt(2 * founder)
    assert abs(d_within - 2 * own) < 6 * np.sqrt(2 * own) + 1


def test_panel_data_does_not_depend_on_the_run_seed(tmp_path):
    """Every run walks the configuration's one panel; the run's seed draws
    only the seed ranges."""
    cell = small_cell()
    gen = cell.datagen("alignments")
    a = gen.make(cell.config, 3, str(tmp_path))
    b = gen.make(cell.config, 2**31 + 9, str(tmp_path))
    assert a["lengths"] == b["lengths"]
    for x, y in zip(a["chunks"], b["chunks"]):
        assert all(np.array_equal(x[k], y[k]) for k in x)


def test_result_line():
    cell = small_cell()
    res = cpu_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"seeds_per_s", "setup_s"}
    for m in cell.end_to_end:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert res["checks"] == {"rows_off": {"value": 0, "limit": 0}}
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("fault", [_alter_hits, _half_batch])
def test_walk_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    # Many small batches, so that the walks the run checks fall on both
    # halves even on a slow machine.
    cell = small_cell()
    cell.mix["batch"] = 16
    res = cpu_run(cell, seconds=3.0)
    assert res["attempted"] >= 2 * cell.mix["batch"]
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 2**31 + 13])
def test_walk_control_fails(seed):
    """The reference in bfloat16 coordinates, in the program's place, misses
    the exact reference on the walks a run checks first."""
    cell = small_cell()
    got = control_panel.walk_control(cell, seed, 3)
    assert got["rows_checked"] > 0
    assert got["rows_off"] > 0
    # control.py's own table is back for the drawn walk cells.
    assert control.walk_table is not control_panel.panel_table


def test_walk_reference_equals_host_engine(tmp_path):
    """The plain reference walk and the program's own host walk agree row
    for row over the panel."""
    from impg_tpu_torch.query import engine as engine_mod

    cell = small_cell()
    data = cell.datagen("alignments").make(cell.config, 21, str(tmp_path))
    table = ref_walk.DirectedTable(data["chunks"], data["names"],
                                   data["lengths"])
    rng = np.random.default_rng(8)
    targets = []
    for _ in range(8):
        sid = int(rng.integers(len(data["names"])))
        s = int(rng.integers(0, 250_000))
        targets.append((sid, s, s + 30_000))
    blocks = engine_mod.query_transitive_bfs_many(data["index"], targets,
                                                  columnar=True)
    for (t, s, e), b in zip(targets, blocks):
        got = np.stack([b.q_id, b.q_first, b.q_last, b.t_id, b.t_first,
                        b.t_last], 1).astype(np.int64)
        want = table.walk(t, s, e)
        assert want.shape[0] > len(data["names"])
        assert ref_walk.rows_off(got, want) == 0
