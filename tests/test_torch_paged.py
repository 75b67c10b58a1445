"""The port's out-of-core paged engine (impg_tpu_torch/query/paged.py) on
the CPU: page plan and stream against the JAX PagedDeviceEngine, the stream
against the port's resident engine, and the transitive BFS against the host
engine under budgets that force many pages and LRU evictions (mirroring
tests/test_paged.py); then the CLI's routing onto it.  Exact equality."""

import random

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.core import arena as arena_mod
from impg_tpu.core.seqidx import SequenceIndex
from impg_tpu.index.impg_index import ImpgIndex
from impg_tpu.io import paf as paf_mod
from impg_tpu.query import engine
from impg_tpu.query.paged import PagedDeviceEngine
from impg_tpu_torch import kernels
from impg_tpu_torch.query import paged as tpaged
from impg_tpu_torch.query.device import RESULT_FIELDS, TorchDeviceEngine
from impg_tpu_torch.query.paged import TorchPagedEngine
from tests import datagen
from tests.test_query import index_from_text

BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")


@pytest.fixture(scope="module")
def setup():
    """tests/test_paged.py's index and walks."""
    rng = random.Random(17)
    text, _seqs, _alns = datagen.pangenome_paf(
        rng, n_seqs=14, seq_len=60_000, cross_links=5
    )
    seq_index = SequenceIndex()
    parsed = paf_mod.parse_paf_bytes(text.encode(), seq_index)
    recs, arena = arena_mod.build_directed(
        query_id=parsed.query_id, q_start=parsed.q_start,
        q_end=parsed.q_end, target_id=parsed.target_id,
        t_start=parsed.t_start, t_end=parsed.t_end, strand=parsed.strand,
        runs=parsed.runs, run_offsets=parsed.run_offsets,
    )
    index = ImpgIndex._finalize(seq_index, recs, arena, [])
    qr = np.random.default_rng(9)
    targets = []
    for _ in range(24):
        tid = int(qr.integers(0, len(seq_index)))
        span = int(qr.integers(2_000, 25_000))
        s = int(qr.integers(0, 60_000 - span))
        targets.append((tid, s, min(s + span, 60_000)))
    return index, targets


def _small_budget(index) -> int:
    # tests/test_paged.py's: index bytes >= 2x the budget.
    total = index.arena.n_ops * 20 + len(index.records) * 24
    return max(total // 2, 1 << 16)


@pytest.fixture(scope="module")
def queries(setup):
    index, _ = setup
    rng = np.random.default_rng(1)
    b = 300
    q_tid = rng.integers(0, len(index.seq_index), b).astype(np.int32)
    q_s = rng.integers(0, 55_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(1, 8_000, b)).astype(np.int32)
    return q_tid, q_s, q_e


@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("share", [1, 3, 16, 1000])
def test_page_edges_match_jax(setup, with_stats, share):
    index, _ = setup
    budget = max((index.arena.n_ops * 20 + len(index.records) * 24) // share,
                 1 << 10)
    ref = PagedDeviceEngine(index, hbm_budget_bytes=budget,
                            with_stats=with_stats)
    got = TorchPagedEngine(index, "cpu", hbm_budget_bytes=budget,
                           with_stats=with_stats)
    assert np.array_equal(got.page_edges, ref.page_edges)
    assert got.n_pages == ref.n_pages
    assert got.page_bytes_each == ref.page_bytes_each
    if share >= 16:
        assert got.n_pages >= 4


def test_page_plan_isolates_oversized_records():
    """A record with more runs than a page holds is a page of its own,
    first record included, as in the JAX loop."""
    op_cnt = np.asarray([5000, 10, 10, 9000, 10, 3, 7000], np.int64)
    edges, _ = tpaged.plan_pages(op_cnt, 1 << 16, False)
    assert edges.tolist() == [0, 1, 3, 4, 6, 7]


def _concat(parts, key):
    return np.concatenate([p[key] for p in parts])


@pytest.mark.parametrize("clip_overlap", [False, True])
@pytest.mark.parametrize(
    "fields,with_stats",
    [(engine.LEAN_FIELDS, False), (engine.LEAN_STATS_FIELDS, True),
     (None, True)],
    ids=["lean", "lean_stats", "all"],
)
def test_stream_matches_jax_and_resident(setup, queries, clip_overlap,
                                         fields, with_stats):
    index, _ = setup
    budget = _small_budget(index)
    ref = list(PagedDeviceEngine(
        index, hbm_budget_bytes=budget, k_slot=16, slot_chunk=64,
        with_stats=with_stats,
    ).query_batch_stream(*queries, clip_overlap=clip_overlap, fields=fields))
    eng = TorchPagedEngine(index, "cpu", hbm_budget_bytes=budget,
                           with_stats=with_stats)
    got = list(eng.query_batch_stream(*queries, clip_overlap=clip_overlap,
                                      fields=fields))
    resident = list(TorchDeviceEngine(index, "cpu").query_batch_stream(
        *queries, clip_overlap=clip_overlap, fields=fields
    ))
    assert len(got) == len(ref) == 1
    assert eng.n_pages >= 4 and eng.uploads >= 4
    keys = set(ref[0])
    assert keys <= set(got[0])
    for key in keys:
        assert np.array_equal(got[0][key], ref[0][key]), key
    for key in set(RESULT_FIELDS) & set(got[0]):
        assert np.array_equal(got[0][key], _concat(resident, key)), key
    n = int(got[0]["n_hits"])
    assert n == got[0]["pair_q"].size > 500
    assert int(got[0]["k_needed"]) == max(int(p["k_needed"]) for p in resident)


def test_window_straddling_page_edge(setup):
    """A query whose window starts in one page and ends in the next yields
    its records in ascending order across the edge."""
    index, _ = setup
    eng = TorchPagedEngine(index, "cpu",
                           hbm_budget_bytes=_small_budget(index) // 4)
    r = index.records
    edge = next(int(e) for e in eng.page_edges[1:-1]
                if r.target_id[e - 1] == r.target_id[e])
    q_tid = np.asarray([r.target_id[edge]], np.int32)
    q_s = np.asarray([r.t_start[edge - 1]], np.int32)
    q_e = np.asarray([max(r.t_start[edge], r.t_start[edge - 1]) + 1],
                     np.int32)
    win_lo = np.asarray([edge - 1], np.int64)
    pieces = list(eng.page_windows(win_lo, np.asarray([2], np.int64)))
    assert [p for p, *_ in pieces] == [
        int(np.searchsorted(eng.page_edges, edge, "right")) - 2,
        int(np.searchsorted(eng.page_edges, edge, "right")) - 1,
    ]
    fields = engine.LEAN_FIELDS + ("pair_rec",)
    got = list(eng.query_batch_stream(q_tid, q_s, q_e, clip_overlap=True,
                                      fields=fields))
    ref = list(TorchDeviceEngine(index, "cpu").query_batch_stream(
        q_tid, q_s, q_e, clip_overlap=True, fields=fields
    ))
    assert {edge - 1, edge} <= set(got[0]["pair_rec"].tolist())
    assert np.all(np.diff(got[0]["pair_rec"]) > 0)
    for key in fields:
        assert np.array_equal(got[0][key], _concat(ref, key)), key


@pytest.mark.parametrize("depth", [2, 3])
def test_paged_bfs_matches_host(setup, depth):
    index, targets = setup
    host = engine.query_transitive_bfs_many(
        index, targets, max_depth=depth, columnar=True
    )
    eng = TorchPagedEngine(index, "cpu",
                           hbm_budget_bytes=_small_budget(index))
    assert eng.n_pages >= 4, "budget should force several pages"
    got = engine.query_transitive_bfs_many(
        index, targets, max_depth=depth, columnar=True, device_engine=eng
    )
    for w, (g, h) in enumerate(zip(got, host)):
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(h, col)), (w, col)
    assert eng.evictions > 0, "LRU should have evicted under this budget"
    assert eng.uploads > eng.n_pages
    assert len(eng._pages) * eng.page_bytes_each <= eng.budget
    assert eng.h2d_bytes > 0 and eng.page_build_s > 0


def test_paged_bfs_at_scale_many_pages():
    """tests/test_paged.py's at-scale case: a 1.7k-record index under a
    budget one third of its lean payload, depth 3, against the host."""
    rng = random.Random(11)
    text, seqs, _ = datagen.pangenome_paf(
        rng, n_seqs=80, seq_len=60_000, cross_links=10
    )
    index = index_from_text(text)
    total = index.arena.n_ops * 20 + len(index.records) * 24
    eng = TorchPagedEngine(index, "cpu", hbm_budget_bytes=total // 3)
    r2 = random.Random(3)
    names = list(seqs)
    targets = []
    for _ in range(6):
        n = r2.choice(names)
        a = r2.randint(0, seqs[n] // 2)
        targets.append((index.seq_index.get_id(n), a,
                        r2.randint(a + 2000, min(seqs[n], a + 20000))))
    host = engine.query_transitive_bfs_many(index, targets, max_depth=3,
                                            columnar=True)
    got = engine.query_transitive_bfs_many(index, targets, max_depth=3,
                                           columnar=True, device_engine=eng)
    total_rows = 0
    for g, h in zip(got, host):
        total_rows += len(h)
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(h, col)), col
    assert total_rows > 10_000
    assert eng.n_pages >= 4 and eng.evictions > 0


def test_lru_matches_jax(setup):
    """Same budget, same walks: the same pages uploaded and evicted as the
    JAX engine, and the budget invariant throughout."""
    index, targets = setup
    budget = _small_budget(index)
    ref = PagedDeviceEngine(index, hbm_budget_bytes=budget, k_slot=16,
                            slot_chunk=64)
    eng = TorchPagedEngine(index, "cpu", hbm_budget_bytes=budget)
    for e in (ref, eng):
        engine.query_transitive_bfs_many(index, targets[:10], max_depth=2,
                                         columnar=True, device_engine=e)
    assert (eng.uploads, eng.evictions) == (ref.uploads, ref.evictions)
    assert list(eng._pages) == list(ref._pages)
    assert len(eng._pages) * eng.page_bytes_each <= budget


def test_paged_stats_fields_guard(setup):
    index, targets = setup
    eng = TorchPagedEngine(index, "cpu",
                           hbm_budget_bytes=_small_budget(index))
    for fields in (engine.LEAN_STATS_FIELDS, None):
        with pytest.raises(ValueError, match="with_stats=True"):
            next(eng.query_batch_stream(
                np.asarray([0], np.int32), np.asarray([0], np.int32),
                np.asarray([100], np.int32), fields=fields,
            ))
    with pytest.raises(NotImplementedError):
        next(eng.query_batch_stream(
            np.asarray([0], np.int32), np.asarray([0], np.int32),
            np.asarray([100], np.int32), approximate=True,
        ))
    assert eng.supports_approximate is False
    # stats -r/-b: K-A's twin over the resident record columns.
    q = [np.asarray(a, np.int32) for a in zip(*targets)]
    assert eng.stab_counts(*q).tolist() == [
        index.stab(t, s, e).size for t, s, e in targets
    ]
    # with_stats=True serves identity-statistics fields (min_identity).
    eng2 = TorchPagedEngine(index, "cpu", with_stats=True,
                            hbm_budget_bytes=2 * _small_budget(index))
    host = engine.query_transitive_bfs_many(
        index, targets[:8], max_depth=2, min_identity=0.9, columnar=True
    )
    got = engine.query_transitive_bfs_many(
        index, targets[:8], max_depth=2, min_identity=0.9, columnar=True,
        device_engine=eng2,
    )
    for g, h in zip(got, host):
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(h, col)), col
    assert eng2.n_pages >= 2


def test_cpu_path_launches_no_kernel(setup, queries):
    index, _ = setup
    eng = TorchPagedEngine(index, "cpu",
                           hbm_budget_bytes=_small_budget(index))
    kernels.reset_launch_counts()
    assert list(eng.query_batch_stream(*queries, fields=engine.LEAN_FIELDS))
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


@pytest.fixture
def paged_instances(monkeypatch):
    """Every TorchPagedEngine built while the test runs."""
    built = []
    original = TorchPagedEngine.__init__

    def init(self, *a, **kw):
        original(self, *a, **kw)
        built.append(self)

    monkeypatch.setattr(TorchPagedEngine, "__init__", init)
    return built


def test_cli_paged_engine_budget_env(tmp_path, capsys, monkeypatch,
                                     paged_instances):
    """--compute-engine device under IMPG_HBM_BUDGET_BYTES=65536 runs the
    paged engine and prints the host's BED bytes (tests/test_paged.py's
    case, through the port's CLI)."""
    rng = random.Random(23)
    text, seqs, _ = datagen.pangenome_paf(rng, n_seqs=8, seq_len=40_000,
                                          cross_links=3)
    paf = tmp_path / "x.paf"
    paf.write_text(text)
    base = ["query", "-a", str(paf), "-r", f"{list(seqs)[0]}:5000-20000",
            "-x", "-o", "bed", "-d", "100"]
    capsys.readouterr()
    assert jax_cli.main(base + ["--compute-engine", "host"]) == 0
    host = capsys.readouterr().out
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", "65536")
    assert torch_cli.main(base + ["--compute-engine", "device"],
                          device="cpu") == 0
    got = capsys.readouterr().out
    assert got == host and len(host.splitlines()) > 2
    assert len(paged_instances) == 1
    eng = paged_instances[0]
    assert eng.budget == 65536 and eng.uploads > 0 and eng.n_pages > 1


def test_cli_paged_stats_regions(tmp_path, capsys, monkeypatch,
                                 paged_instances):
    """`stats -b` under a budget that pages the index counts each region's
    records through the paged engine's stab_counts, byte-equal to host."""
    rng = random.Random(29)
    text, seqs, _ = datagen.pangenome_paf(rng, n_seqs=8, seq_len=40_000,
                                          cross_links=3)
    paf = tmp_path / "x.paf"
    paf.write_text(text)
    bed = tmp_path / "regions.bed"
    bed.write_text("".join(f"{n}\t{s}\t{s + 7000}\n" for n in list(seqs)[:5]
                           for s in (0, 11_000, 30_000)))
    base = ["stats", "-a", str(paf), "-b", str(bed)]
    capsys.readouterr()
    assert jax_cli.main(base + ["--compute-engine", "host"]) == 0
    host = capsys.readouterr().out
    calls = []
    original = TorchPagedEngine.stab_counts
    monkeypatch.setattr(TorchPagedEngine, "stab_counts",
                        lambda self, *q: calls.append(q) or original(self, *q))
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", "65536")
    assert torch_cli.main(base + ["--compute-engine", "device"],
                          device="cpu") == 0
    got = capsys.readouterr().out
    assert got == host and len(host.splitlines()) == 16
    assert len(paged_instances) == 1 and paged_instances[0].n_pages > 1
    assert len(calls) == 1 and calls[0][0].size == 15
    assert sum(int(line.split("\t")[1]) for line in host.splitlines()[1:]) > 0


class _WideArena:
    """An arena that reports 2^31 runs and is otherwise the index's own."""

    def __init__(self, arena):
        self._arena = arena

    n_ops = 2**31

    def __getattr__(self, name):
        return getattr(self._arena, name)


class _WideIndex:
    def __init__(self, index):
        self._index = index
        self.arena = _WideArena(index.arena)

    def __getattr__(self, name):
        return getattr(self._index, name)


def test_resolver_pages_arenas_past_int32(setup, monkeypatch,
                                          paged_instances):
    """An arena of 2^31 runs or more is paged whatever the budget; the
    resident engine would refuse it."""
    index, _ = setup
    args = type("Args", (), {"compute_engine": "device"})()
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", str(1 << 62))
    resolve = torch_cli.resolve_compute_engine
    dev = torch_cli.torch.device("cpu")
    assert isinstance(resolve(args, index, device=dev), TorchDeviceEngine)
    wide = resolve(args, _WideIndex(index), device=dev)
    assert isinstance(wide, TorchPagedEngine) and paged_instances == [wide]
    assert wide.budget == 1 << 62
    # Approximate walks never page (the paged engine refuses them), and
    # their engine uploads no arena, so its size does not matter.
    for ix in (index, _WideIndex(index)):
        approx = resolve(args, ix, approximate=True, device=dev)
        assert isinstance(approx, TorchDeviceEngine)
        assert approx.supports_approximate and not approx.dindex.arena
    assert len(paged_instances) == 1


def test_resolver_approximate_past_budget_goes_to_host(setup, monkeypatch):
    """Approximate walks whose record and tracepoint columns pass the budget
    run on the host: no device engine pages tracepoints."""
    index, _ = setup
    tp = index.ensure_tracepoints()
    need = tp.q_bound.size * 12 + len(index.records) * 48
    args = type("Args", (), {"compute_engine": "device"})()
    dev = torch_cli.torch.device("cpu")
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", str(need))
    assert isinstance(torch_cli.resolve_compute_engine(
        args, index, approximate=True, device=dev), TorchDeviceEngine)
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", str(need - 1))
    assert torch_cli.resolve_compute_engine(
        args, index, approximate=True, device=dev) is None


def test_device_budget_sources(monkeypatch):
    dev = torch_cli.torch.device("cpu")
    monkeypatch.delenv("IMPG_HBM_BUDGET_BYTES", raising=False)
    assert torch_cli.device_budget(dev) == 12 << 30
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", "4096")
    assert torch_cli.device_budget(dev) == 4096
