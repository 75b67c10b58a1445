"""Port's device engine (CPU tensors: the kernels' plain twins) vs the JAX
DeviceEngine on the CPU backend, on the same index and queries.  Every
output is an integer: exact equality, field by field and in order."""

import random

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
