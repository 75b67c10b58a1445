"""Port's device engine (CPU tensors: the kernels' plain twins) vs the JAX
DeviceEngine on the CPU backend, on the same index and queries.  Every
output is an integer: exact equality, field by field and in order."""

import random
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from impg_tpu.query import engine
from impg_tpu.query.device import DeviceEngine, DeviceIndex
from impg_tpu.query.device import compute_cummax_te as jax_cummax
from impg_tpu.query.device import stab_windows as jax_stab_windows
from impg_tpu_torch import kernels
from impg_tpu_torch.query import device as tdev
from tests import datagen
from tests.test_query import index_from_text


@pytest.fixture(scope="module")
def index():
    rng = random.Random(11)
    text, _, _ = datagen.pangenome_paf(
        rng, n_seqs=12, seq_len=20_000, cross_links=4
    )
    return index_from_text(text)


@pytest.fixture(scope="module")
def queries(index):
    rng = np.random.default_rng(0)
    b = 200
    q_tid = rng.integers(0, len(index.seq_index), b).astype(np.int32)
    q_s = rng.integers(0, 15_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(1, 5_000, b)).astype(np.int32)
    return q_tid, q_s, q_e


@pytest.fixture(scope="module")
def port(index):
    return tdev.TorchDeviceEngine(index, device="cpu")


@pytest.fixture(scope="module")
def jax_engines(index):
    return {
        slotted: DeviceEngine(index, slotted=slotted)
        for slotted in (False, True)
    }


def _concat(parts, key):
    return np.concatenate([p[key] for p in parts]) if parts else None


def test_from_arrays_equals_jax_upload(index):
    d = DeviceIndex.build(index)  # eager stats: every arena array
    arrays = {
        k: np.asarray(getattr(d, k))
        for k in (*tdev.TorchDeviceIndex.RECORD_KEYS, "cummax_te",
                  "tgt_offsets")
    }
    arrays.update({k: np.asarray(v) for k, v in d.arena.items()})
    from_jax = tdev.TorchDeviceIndex.from_arrays(arrays, "cpu")
    built = tdev.TorchDeviceIndex.build(index, "cpu")
    assert set(built.arena) == set(tdev.TorchDeviceIndex.PROJECTION_CORE)
    built.upload_stats(index.arena.projection_kwargs())
    for up in (from_jax, built):
        assert (up.n_records, up.search_iters, up.window_iters) == (
            d.n_records, d.search_iters, d.window_iters
        )
        for k in (*tdev.TorchDeviceIndex.RECORD_KEYS, "cummax_te",
                  "tgt_offsets"):
            t = getattr(up, k)
            assert t.dtype == torch.int32, k
            assert np.array_equal(t.numpy(), np.asarray(getattr(d, k))), k
        assert set(up.arena) == set(d.arena)
        for k, v in d.arena.items():
            assert np.array_equal(
                up.arena[k].numpy(), np.asarray(v).view(np.int32)
            ), k


def test_cummax_matches_jax_helper(index):
    r = index.records
    assert np.array_equal(
        tdev.compute_cummax_te(r.t_end, index.tgt_offsets),
        jax_cummax(r.t_end, index.tgt_offsets),
    )


def test_stab_windows_match_jax(index, port, queries):
    q_tid, q_s, q_e = queries
    d = port.dindex
    args = (torch.from_numpy(a) for a in queries)
    win_lo, k = tdev.stab_windows(d.tgt_offsets, d.t_start, d.cummax_te,
                                  *args, d.window_iters)
    jd = DeviceIndex.build(index, stats=False)
    j_lo, j_k = jax_stab_windows(
        jd.tgt_offsets, jd.t_start, jd.cummax_te, jnp.asarray(q_tid),
        jnp.asarray(q_s), jnp.asarray(q_e), jd.window_iters, jd.n_records,
    )
    assert np.array_equal(win_lo.numpy(), np.asarray(j_lo))
    assert np.array_equal(k.numpy(), np.asarray(j_k))
    assert int(k.sum()) > 0
    # Out-of-range targets (the tid = -1 padding convention) get no window.
    bad = torch.tensor([-1, len(index.seq_index)], dtype=torch.int32)
    z = torch.zeros(2, dtype=torch.int32)
    _, k_bad = tdev.stab_windows(d.tgt_offsets, d.t_start, d.cummax_te, bad,
                                 z, z + 100, d.window_iters)
    assert k_bad.tolist() == [0, 0]


def _windows_case(case, index, port, queries):
    """(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e) int32 numpy for
    one case of test_windows_offsets_match_jax."""
    d = port.dindex
    cols = tuple(getattr(d, k).numpy() for k in
                 ("tgt_offsets", "t_start", "cummax_te"))
    q_tid, q_s, q_e = (a.copy() for a in queries)
    n_seqs = len(index.seq_index)
    if case == "index":
        q_tid[::5] = -1
        q_tid[1::7] = n_seqs
        q_tid[2::11] = n_seqs + 1000
        return (*cols, q_tid, q_s, q_e)
    if case == "b0":
        return (*cols, *(a[:0] for a in (q_tid, q_s, q_e)))
    if case == "b1":
        return (*cols, *(a[:1] for a in (q_tid, q_s, q_e)))
    if case == "not_block_multiple":
        # Two blocks of 128 queries and one more.
        rng = np.random.default_rng(3)
        b = 2 * tdev._WINDOWS_THREADS + 1
        q_tid = rng.integers(-1, n_seqs + 1, b).astype(np.int32)
        q_s = rng.integers(0, 15_000, b).astype(np.int32)
        return (*cols, q_tid, q_s, (q_s + rng.integers(1, 8_000, b)).astype(
            np.int32))
    rng = np.random.default_rng(4)
    if case == "empty_segments":
        # Targets 0, 2, 3 and 5 hold no records.
        tgt_offsets = np.array([0, 0, 5, 5, 5, 12, 12], np.int32)
        t_start = np.concatenate([np.sort(rng.integers(0, 900, 5)),
                                  np.sort(rng.integers(0, 900, 7))])
        t_end = t_start + rng.integers(1, 300, 12)
        cummax = tdev.compute_cummax_te(t_end, tgt_offsets)
        b = 300
        q_tid = rng.integers(-1, 8, b).astype(np.int32)
        q_s = rng.integers(0, 1000, b).astype(np.int32)
        return (tgt_offsets, t_start.astype(np.int32), cummax, q_tid, q_s,
                (q_s + rng.integers(0, 400, b)).astype(np.int32))
    assert case == "past_2^31"
    # One segment of 2^16 records that all overlap every query: 2^16 + 3
    # windows of 2^16 lanes each, 2^32 + 3 * 2^16 lanes in all.
    n = 1 << 16
    tgt_offsets = np.array([0, n], np.int32)
    t_start = np.arange(n, dtype=np.int32)
    t_end = (t_start + 1_000_000).astype(np.int32)
    b = n + 3
    return (tgt_offsets, t_start, tdev.compute_cummax_te(t_end, tgt_offsets),
            np.zeros(b, np.int32), np.full(b, n, np.int32),
            np.full(b, 2_000_000, np.int32))


@pytest.mark.parametrize("case", ["index", "b0", "b1", "not_block_multiple",
                                  "empty_segments", "past_2^31"])
def test_windows_offsets_match_jax(index, port, queries, case):
    """K-B's plain twin, its CPU entry and the engines' front, against
    impg_tpu's stab_windows plus np.cumsum, exactly: tids -1 and >= n_seqs
    (the JAX engine's padding, which its lane grid masks: no window here),
    empty segments, batches of 0 and 1 and of two blocks and one query, and
    lanes past 2^31."""
    tgt_offsets, t_start, cummax, q_tid, q_s, q_e = _windows_case(
        case, index, port, queries)
    n_seqs = tgt_offsets.size - 1
    iters = tdev._iters_for(int(np.diff(tgt_offsets).max()))
    j_lo, j_k = (np.asarray(a) for a in jax_stab_windows(
        *(jnp.asarray(a) for a in (tgt_offsets, t_start, cummax, q_tid, q_s,
                                   q_e)), iters, t_start.size))
    ok = (q_tid >= 0) & (q_tid < n_seqs)
    want_lo, want_k = np.where(ok, j_lo, 0), np.where(ok, j_k, 0)
    want_offs = np.concatenate([[0], np.cumsum(want_k, dtype=np.int64)])
    t = [torch.from_numpy(a) for a in (tgt_offsets, t_start, cummax, q_tid,
                                       q_s, q_e)]
    front = tdev.DepthFront(SimpleNamespace(
        tgt_offsets=t[0], t_start=t[1], cummax_te=t[2], window_iters=iters,
        device=torch.device("cpu")))
    b = q_tid.size
    q, lo_f, k_f, offs_f, offs_h, lo_h = front.windows(q_tid, q_s, q_e,
                                                       host_windows=True)
    assert q.dtype == torch.int32
    assert np.array_equal(q[:, :b].numpy(), np.stack([q_tid, q_s, q_e]))
    got_front = (lo_f[:b], k_f[:b], offs_f[:b + 1])
    for got in (tdev.windows_offsets_plain(*t, iters),
                tdev.windows_offsets(*t, iters), got_front):
        lo, k, offs = (a.numpy() for a in got)
        assert (lo.dtype, k.dtype, offs.dtype) == (np.int32, np.int32,
                                                   np.int64)
        assert np.array_equal(lo, want_lo)
        assert np.array_equal(k, want_k)
        assert np.array_equal(offs, want_offs)
    assert np.array_equal(offs_h, want_offs)
    assert np.array_equal(lo_h, want_lo)
    if case == "past_2^31":
        assert int(offs[-1]) == (1 << 32) + 3 * (1 << 16)
    if case == "index":
        assert int(want_k.sum()) > 0 and not want_k[~ok].any()


@pytest.mark.parametrize("slotted", [False, True], ids=["windowed", "slotted"])
@pytest.mark.parametrize("clip_overlap", [False, True])
@pytest.mark.parametrize(
    "fields", [None, engine.LEAN_FIELDS, engine.LEAN_STATS_FIELDS],
    ids=["all", "lean", "lean_stats"],
)
def test_stream_matches_jax(port, jax_engines, queries, slotted, clip_overlap,
                            fields):
    ref = list(jax_engines[slotted].query_batch_stream(
        *queries, clip_overlap=clip_overlap, fields=fields
    ))
    got = list(port.query_batch_stream(
        *queries, clip_overlap=clip_overlap, fields=fields
    ))
    assert got
    assert set(got[0]) == set(ref[0])
    for key in ref[0]:
        if key in ("k_needed", "n_hits"):
            continue
        g = _concat(got, key)
        assert g.dtype == (bool if key == "valid" else np.int32), key
        assert np.array_equal(g, _concat(ref, key)), key
    assert all(p["valid"].all() for p in got)
    total = sum(int(p["n_hits"]) for p in got)
    assert total == sum(int(p["n_hits"]) for p in ref) == g.size > 100


def test_stream_chunking_is_invisible(index, port, queries):
    """A tiny lane budget splits the batch into many chunks; the
    concatenated stream must not change."""
    small = tdev.TorchDeviceEngine(index, device="cpu")
    small.lane_budget = 37
    whole = list(port.query_batch_stream(*queries, clip_overlap=True))
    parts = list(small.query_batch_stream(*queries, clip_overlap=True))
    assert len(whole) == 1 and len(parts) > 10
    for key in tdev.RESULT_FIELDS:
        assert np.array_equal(_concat(parts, key), _concat(whole, key)), key
    assert max(int(p["k_needed"]) for p in parts) == int(whole[0]["k_needed"])


def test_second_stream_stops_the_first(index, port, queries):
    """A stream started on an engine whose earlier stream is not drained
    reuses the engine's K-B buffers: the earlier stream raises at its next
    chunk instead of projecting the later stream's queries, and the later
    stream is whole."""
    small = tdev.TorchDeviceEngine(index, device="cpu")
    small.lane_budget = 37
    first = small.query_batch_stream(*queries, clip_overlap=True)
    next(first)
    second = list(small.query_batch_stream(*queries, clip_overlap=True))
    with pytest.raises(RuntimeError, match="one stream at a time"):
        next(first)
    whole = list(port.query_batch_stream(*queries, clip_overlap=True))
    for key in tdev.RESULT_FIELDS:
        assert np.array_equal(_concat(second, key), _concat(whole, key)), key


def test_query_batch_matches_jax(jax_engines, port, queries):
    ref = jax_engines[False].query_batch(*queries)
    got = port.query_batch(*queries)
    assert set(got) == set(ref)
    for key in ref:
        assert np.array_equal(np.asarray(got[key]), np.asarray(ref[key])), key
    empty = port.query_batch(*(np.zeros(0, np.int32) for _ in range(3)))
    assert int(empty["n_hits"]) == 0
    assert all(np.size(empty[f]) == 0 for f in tdev.RESULT_FIELDS)


def test_engine_stab_counts_match_jax(index, jax_engines, port, queries):
    q_tid, q_s, q_e = queries
    q_tid = q_tid.copy()
    q_tid[::7] = -1
    got = port.stab_counts(q_tid, q_s, q_e)
    ref = jax_engines[False].stab_counts(q_tid, q_s, q_e)
    assert got.dtype == np.int32
    assert np.array_equal(got, ref)
    for i in range(0, q_tid.size, 9):
        if q_tid[i] >= 0:
            assert got[i] == index.stab(q_tid[i], q_s[i], q_e[i]).size


def test_compact_keeps_lane_order():
    rng = np.random.default_rng(2)
    valid = torch.from_numpy((rng.random(3000) < 0.3).astype(np.uint8))
    rows = torch.from_numpy(rng.integers(-9, 9, (4, 3000)).astype(np.int32))
    got = tdev.compact(valid, rows)
    order = np.argsort(~valid.numpy().astype(bool), kind="stable")
    n = int(valid.sum())
    assert np.array_equal(got.numpy(), rows.numpy()[:, order[:n]])


def test_engine_contract(index, port, queries):
    assert port.supports_approximate is False
    with pytest.raises(ValueError):
        next(port.query_batch_stream(*queries, approximate=True))
    if torch.cuda.is_available():
        pytest.skip("checks the CUDA-absent error; this host has CUDA")
    with pytest.raises(RuntimeError):
        tdev.TorchDeviceEngine(index, device="cuda")


def test_cpu_path_launches_no_kernel(port, queries):
    kernels.reset_launch_counts()
    assert list(port.query_batch_stream(*queries))
    port.stab_counts(*queries)
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNELS, 0)


def test_parse_ptxas_report():
    log = (
        "ptxas info    : Compiling entry function 'impg_k_windows' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for impg_k_windows\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 19 registers, used 0 barriers, 416 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function 'impg_k_stab_count' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 35 registers, 12288 bytes smem, 412 bytes "
        "cmem[0]\n"
    )
    assert kernels.parse_ptxas(log) == {
        "impg_k_windows": dict(spill_stores=0, spill_loads=0, registers=19,
                               smem=0),
        "impg_k_stab_count": dict(spill_stores=8, spill_loads=4,
                                  registers=35, smem=12288),
    }


def test_arena_layout_interleaves_run_and_stats_columns():
    """On the device the RUN_KEYS and the STATS_KEYS are column views of one
    [n_runs, 4] and one [n_runs, 6] tensor, cum_t an array of its own: the
    layout K-C reads.  Separate arrays are refused before a launch."""
    D = tdev.TorchDeviceIndex
    keys = D.PROJECTION_CORE + D.STATS_KEYS
    arrays = {k: np.arange(7, dtype=np.int32) * 10 + i
              for i, k in enumerate(keys)}
    arena = tdev.arena_tensors(arrays, keys, "cpu")
    assert set(arena) == set(keys)
    for k, v in arrays.items():
        assert np.array_equal(arena[k].numpy(), v), k
    assert arena["cum_t"].is_contiguous()
    for group in (D.RUN_KEYS, D.STATS_KEYS):
        assert tdev._columns_base(arena, group) == arena[group[0]].data_ptr()
        separate = {k: torch.from_numpy(arrays[k]) for k in group}
        with pytest.raises(ValueError, match="interleaved"):
            tdev._columns_base(separate, group)
    with pytest.raises(ValueError, match="together"):
        tdev.arena_tensors(arrays, ("runs", "cum_t"), "cpu")
