"""The port past the int32 ceiling on the CPU: an index whose arena holds
2^31 runs and more, made by moving a small index's arena to the tail of
sparse files (synth.shift_arena), so that every op_off passes 2^31 while
the runs stay the small index's.  The paged engine (one page, and many
with LRU evictions) against the JAX PagedDeviceEngine on the same shifted
index and against the unshifted index's walks; K-A's counts; the resolver's
route; the tracepoints and the approximate route, which impg_tpu refuses
past 2^31 and the port serves; the refusal of a page past int32; and a CPU
rehearsal of chip_scale.py.  Every comparison is exact equality."""

import os
import random
import types

import numpy as np
import pytest

import impg_tpu_torch.cli as torch_cli
from impg_tpu.core.seqidx import SequenceIndex as JaxSequenceIndex
from impg_tpu.index.impg_index import ImpgIndex as JaxImpgIndex
from impg_tpu.io import paf as jax_paf
from impg_tpu.query import engine as jax_engine
from impg_tpu.query.device import DeviceEngine
from impg_tpu.query.paged import PagedDeviceEngine
from impg_tpu_torch import synth
from impg_tpu_torch.core import arena as arena_mod
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.index.impg_index import ImpgIndex
from impg_tpu_torch.io import paf as paf_mod
from impg_tpu_torch.ops import xfer
from impg_tpu_torch.query import device as tdev
from impg_tpu_torch.query import engine
from impg_tpu_torch.query import paged as tpaged
from impg_tpu_torch.query.device import TorchDeviceEngine
from impg_tpu_torch.query.host_native import NativeHostEngine
from impg_tpu_torch.query.paged import TorchPagedEngine
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")
SHIFT = 2**31


def _build(text, seq_cls, paf, build_directed, finalize):
    seq_index = seq_cls()
    p = paf.parse_paf_bytes(text.encode(), seq_index)
    recs, arena = build_directed(
        query_id=p.query_id, q_start=p.q_start, q_end=p.q_end,
        target_id=p.target_id, t_start=p.t_start, t_end=p.t_end,
        strand=p.strand, runs=p.runs, run_offsets=p.run_offsets)
    return finalize(seq_index, recs, arena, [])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(the port's index, the same index shifted past 2^31, impg_tpu's
    index of the same PAF, the walks' seeds), as tests/test_torch_paged.py
    builds its index."""
    from impg_tpu.core import arena as jax_arena

    rng = random.Random(17)
    text, _seqs, _alns = datagen.pangenome_paf(
        rng, n_seqs=14, seq_len=60_000, cross_links=5)
    index = _build(text, SequenceIndex, paf_mod, arena_mod.build_directed,
                   ImpgIndex._finalize)
    ref = _build(text, JaxSequenceIndex, jax_paf, jax_arena.build_directed,
                 JaxImpgIndex._finalize)
    shifted = synth.shift_arena(index, str(tmp_path_factory.mktemp("wide")))
    qr = np.random.default_rng(9)
    targets = []
    for _ in range(24):
        tid = int(qr.integers(0, len(index.seq_index)))
        span = int(qr.integers(2_000, 25_000))
        s = int(qr.integers(0, 60_000 - span))
        targets.append((tid, s, min(s + span, 60_000)))
    return index, shifted, ref, targets


def _lean(index) -> int:
    return index.arena.n_ops * 20 + len(index.records) * 24


# A budget that holds the whole shifted index's runs in one page, and one
# that cuts it into many (tests/test_paged.py's: half the lean bytes).
BUDGETS = {"one_page": 1 << 40, "many_pages": None}


def _budget(index, name) -> int:
    return BUDGETS[name] or max(_lean(index) // 2, 1 << 16)


@pytest.fixture(scope="module")
def queries(setup):
    index = setup[0]
    rng = np.random.default_rng(1)
    b = 300
    q_tid = rng.integers(0, len(index.seq_index), b).astype(np.int32)
    q_s = rng.integers(0, 55_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(1, 8_000, b)).astype(np.int32)
    return q_tid, q_s, q_e


def _rows_equal(got, ref) -> int:
    assert len(got) == len(ref)
    for w, (g, r) in enumerate(zip(got, ref)):
        for col in BLOCK_COLUMNS:
            assert np.array_equal(getattr(g, col), getattr(r, col)), (w, col)
    return sum(len(r) for r in ref)


def test_shifted_index_passes_int32(setup):
    """Every op_off past 2^31, the columns memmaps of the index's own dtypes
    (runs uint32) holding its runs at their tail, the stats unbuilt, and
    the hole not written."""
    index, shifted, _, _ = setup
    a, w = index.arena, shifted.arena
    assert w.n_ops == SHIFT + a.n_ops
    assert int(shifted.records.op_off.min()) >= SHIFT
    assert np.array_equal(shifted.records.op_off - SHIFT, index.records.op_off)
    for k in arena_mod.CigarArena.EAGER_FIELDS:
        col = getattr(w, k)
        assert isinstance(col, np.memmap) and col.dtype == getattr(a, k).dtype
        assert np.array_equal(col[SHIFT:], getattr(a, k)), k
        assert os.stat(col.filename).st_blocks * 512 < 64 * a.n_ops + (1 << 24)
    assert w.runs.dtype == np.uint32 and not w.stats_materialized
    assert w.seg_offsets[0] == 0 and w.seg_offsets[1] == SHIFT


@pytest.mark.parametrize("pages", list(BUDGETS))
def test_paged_stream_matches_jax_past_int32(setup, queries, pages):
    """One depth's stream over the shifted index: the JAX engine's on the
    same index, and the port's over the unshifted one."""
    index, shifted, _, _ = setup
    budget = _budget(index, pages)
    fields = engine.LEAN_FIELDS + ("pair_rec",)
    ref = list(PagedDeviceEngine(shifted, hbm_budget_bytes=budget, k_slot=16,
                                 slot_chunk=64).query_batch_stream(
        *queries, clip_overlap=True, fields=fields))
    eng = TorchPagedEngine(shifted, "cpu", hbm_budget_bytes=budget)
    got = list(eng.query_batch_stream(*queries, clip_overlap=True,
                                      fields=fields))
    base = list(TorchPagedEngine(index, "cpu", hbm_budget_bytes=budget)
                .query_batch_stream(*queries, clip_overlap=True,
                                    fields=fields))
    assert len(got) == len(ref) == len(base) == 1
    for key in set(ref[0]) & set(got[0]):
        assert np.array_equal(got[0][key], ref[0][key]), key
    for key in fields:
        assert np.array_equal(got[0][key], base[0][key]), key
    assert int(got[0]["n_hits"]) > 500
    assert (eng.n_pages == 1) == (pages == "one_page")


@pytest.mark.parametrize("pages", list(BUDGETS))
def test_paged_walk_matches_jax_past_int32(setup, pages):
    """Depth-2 walks over the shifted index through the port's paged engine:
    the rows of the JAX paged engine on the same index, of impg_tpu's host
    engine on the unshifted one, and of the native engine over the shifted
    memmaps, which it takes without a copy; with evictions under the small
    budget."""
    index, shifted, ref_index, targets = setup
    budget = _budget(index, pages)
    eng = TorchPagedEngine(shifted, "cpu", hbm_budget_bytes=budget)
    got = engine.query_transitive_bfs_many(shifted, targets, max_depth=2,
                                           columnar=True, device_engine=eng)
    jax_paged = jax_engine.query_transitive_bfs_many(
        shifted, targets, max_depth=2, columnar=True,
        device_engine=PagedDeviceEngine(shifted, hbm_budget_bytes=budget,
                                        k_slot=16, slot_chunk=64))
    host = jax_engine.query_transitive_bfs_many(ref_index, targets,
                                                max_depth=2, columnar=True)
    native_eng = NativeHostEngine(shifted)
    native = engine.query_transitive_bfs_many(
        shifted, targets, max_depth=2, columnar=True,
        device_engine=native_eng)
    assert _rows_equal(got, jax_paged) > 1000
    _rows_equal(got, host)
    _rows_equal(native, host)
    for k in ("runs", "cum_t", "cum_q", "irb", "ira", "op_off"):
        assert np.shares_memory(
            native_eng._keep[k],
            shifted.records.op_off if k == "op_off" else getattr(
                shifted.arena, {"irb": "irun_before",
                                "ira": "irun_after"}.get(k, k))), k
    if pages == "many_pages":
        assert eng.n_pages >= 4 and eng.evictions > 0
        assert eng.uploads > eng.n_pages
    else:
        assert eng.n_pages == 1 and eng.evictions == 0


def test_page_build_in_blocks(setup, monkeypatch):
    """A page gathered in record blocks of 3 and staged 1,000 values at a
    time holds the same columns as one gathered whole."""
    _, shifted, _, _ = setup
    eng = TorchPagedEngine(shifted, "cpu", hbm_budget_bytes=1 << 40)
    whole = eng._build_page(0)
    monkeypatch.setattr(tpaged, "PAGE_BLOCK", 3)
    monkeypatch.setattr(xfer, "STAGE_ELEMS", 1000)
    blocks = eng._build_page(0)
    assert set(whole.arena) == set(blocks.arena)
    for k in whole.arena:
        assert np.array_equal(whole.arena[k].numpy(), blocks.arena[k].numpy())
    assert np.array_equal(whole.op_off.numpy(), blocks.op_off.numpy())
    r = shifted.records
    run = int(r.op_off[0]) + 5
    page_row = int(whole.op_off[0]) + 5
    assert int(whole.arena["cum_t"][page_row]) == int(shifted.arena.cum_t[run])


def test_stab_counts_past_int32(setup):
    index, shifted, _, targets = setup
    eng = TorchPagedEngine(shifted, "cpu",
                           hbm_budget_bytes=_budget(index, "many_pages"))
    q = [np.asarray(a, np.int32) for a in zip(*targets)]
    want = [index.stab(t, s, e).size for t, s, e in targets]
    assert eng.stab_counts(*q).tolist() == want and sum(want) > 0


def test_resolver_pages_the_shifted_index(setup, monkeypatch):
    """`--compute-engine device` pages the real shifted index at any budget,
    and serves the unshifted one resident under a budget that holds it."""
    index, shifted, _, _ = setup
    args = types.SimpleNamespace(compute_engine="device")
    dev = torch_cli.torch.device("cpu")
    monkeypatch.setenv("IMPG_HBM_BUDGET_BYTES", str(1 << 50))
    eng = torch_cli.resolve_compute_engine(args, shifted, device=dev)
    assert isinstance(eng, TorchPagedEngine) and eng.n_pages == 1
    assert isinstance(torch_cli.resolve_compute_engine(args, index,
                                                       device=dev),
                      TorchDeviceEngine)
    with pytest.raises(ValueError, match="arena too large"):
        tdev.TorchDeviceIndex.build(shifted, "cpu")


def test_approximate_past_int32_port_serves_impg_tpu_refuses(setup):
    """Approximate walks over an arena past 2^31: impg_tpu's DeviceEngine
    refuses the index, the port's tracepoint engine (the resolver's pick)
    keeps no op_off and gives the unshifted index's rows; the tracepoints
    built over the shifted arena equal the unshifted ones."""
    index, shifted, _, targets = setup
    with pytest.raises(ValueError, match="arena too large"):
        DeviceEngine(shifted, with_tracepoints=True)
    args = types.SimpleNamespace(compute_engine="device")
    eng = torch_cli.resolve_compute_engine(
        args, shifted, approximate=True, device=torch_cli.torch.device("cpu"))
    assert isinstance(eng, TorchDeviceEngine) and eng.supports_approximate
    assert eng.dindex.op_off.numel() == 0 and not eng.dindex.arena
    tp, base_tp = shifted.tp, index.ensure_tracepoints()
    for f in base_tp.FIELDS:
        assert np.array_equal(getattr(tp, f), getattr(base_tp, f)), f
    got = engine.query_transitive_bfs_many(shifted, targets, max_depth=2,
                                           columnar=True, approximate=True,
                                           device_engine=eng)
    want = engine.query_transitive_bfs_many(
        index, targets, max_depth=2, columnar=True, approximate=True,
        device_engine=TorchDeviceEngine(index, "cpu", with_tracepoints=True))
    assert _rows_equal(got, want) > 1000
    with pytest.raises(ValueError, match="arena too large"):
        eng._ensure_arena()


def test_page_past_int32_is_refused():
    """A page of 2^31 runs would pass its int32 offsets: the plan (the JAX
    engine's edges) makes it at a budget past about 172 GB, and the engine
    refuses it before any upload, naming the page."""
    op_cnt = np.asarray([2**30, 2**30, 5], np.int32)
    edges, _ = tpaged.plan_pages(op_cnt, 1 << 62, False)
    assert edges.tolist() == [0, 3]
    with pytest.raises(ValueError, match=r"page 0 of 1 .* 2147483653 runs"):
        tpaged.check_page_runs(op_cnt, edges)
    index = types.SimpleNamespace(records=types.SimpleNamespace(
        op_cnt=op_cnt))
    with pytest.raises(ValueError, match="page 0 of 1"):
        TorchPagedEngine(index, "cpu", hbm_budget_bytes=1 << 62)
    edges, _ = tpaged.plan_pages(op_cnt, 1 << 34, False)
    assert edges.size > 2
    tpaged.check_page_runs(op_cnt, edges)


def test_staged_upload_over_stage_boundaries(monkeypatch):
    """upload_i32_rows over blocks and staging chunks smaller than the
    columns: groups of one and of several columns, slices and index
    arrays, int64 and uint32 sources, the range check of as_i32 and the
    wrap of the tracepoint prefixes."""
    monkeypatch.setattr(xfer, "STAGE_ELEMS", 7)
    rng = np.random.default_rng(5)
    cols = [rng.integers(-2**31, 2**31, 50).astype(np.int64),
            rng.integers(0, 2**32, 50, dtype=np.uint64).astype(np.uint32),
            np.arange(50, dtype=np.int32)]
    t = xfer.upload_i32_columns(cols, "cpu")
    assert t.shape == (50, 3)
    assert np.array_equal(t[:, 0].numpy(), cols[0])
    assert np.array_equal(t[:, 1].numpy(), cols[1].view(np.int32))
    assert np.array_equal(t[:, 2].numpy(), cols[2])
    idx = rng.permutation(50)
    blocks = [(0, idx[:23]), (23, slice(3, 10)), (30, idx[30:])]
    one, two = xfer.upload_i32_rows([[cols[2]], cols[1:]], 50, blocks, "cpu")
    rows = np.concatenate([idx[:23], np.arange(3, 10), idx[30:]])
    assert one.shape == (50, 1) and two.shape == (50, 2)
    assert np.array_equal(one[:, 0].numpy(), cols[2][rows])
    assert np.array_equal(two[:, 0].numpy(), cols[1].view(np.int32)[rows])
    assert np.array_equal(two[:, 1].numpy(), cols[2][rows])
    with pytest.raises(ValueError, match="do not fit int32"):
        xfer.upload_i32_columns([np.asarray([2**31], np.int64)], "cpu")
    wrapped = xfer.upload_i32_columns([np.asarray([2**31 + 5], np.int64)],
                                      "cpu", wrap=True)
    assert int(wrapped[0, 0]) == -(2**31) + 5
