"""Port's stab-count wrapper (plain twin on CPU tensors) vs the JAX Pallas
kernel in interpret mode and the numpy oracle; then K-A's segmented count
(its plain version, over the layout of arbitrary records and over the
engines' layout) against both, on degenerate queries and records, and the
engines' `stab_counts` against the JAX engine's.  Integer outputs: exact."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from impg_tpu.ops import pallas_stab as ps
from impg_tpu_torch.ops import stab_count as sc
from tests import datagen
from tests.test_query import index_from_text


def _case(seed, n, b, tid_neg=False):
    rng = np.random.default_rng(seed)
    rec_tid = rng.integers(0, 8, n).astype(np.int32)
    rec_ts = rng.integers(0, 50_000, n).astype(np.int32)
    rec_te = (rec_ts + rng.integers(1, 3000, n)).astype(np.int32)
    q_tid = rng.integers(-1 if tid_neg else 0, 8, b).astype(np.int32)
    q_s = rng.integers(0, 50_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(1, 10_000, b)).astype(np.int32)
    return rec_tid, rec_ts, rec_te, q_tid, q_s, q_e


@pytest.mark.parametrize(
    "seed,n,b,tid_neg",
    [
        (3, 4000, 300, False),  # ragged N (not a tile multiple), B = 300
        (4, 1030, 1, False),  # one query, N just past one tile
        (5, 2500, 64, True),  # tid = -1 queries
        (6, 0, 16, False),  # empty record set
        (7, 1024, 300, True),  # exactly one tile
    ],
)
def test_stab_counts_match_pallas_and_oracle(seed, n, b, tid_neg):
    arrays = _case(seed, n, b, tid_neg)
    rec_tid, rec_ts, rec_te, q_tid, q_s, q_e = arrays
    got = sc.stab_counts(*(torch.from_numpy(a) for a in arrays)).numpy()
    padded = ps.pad_records(rec_tid, rec_ts, rec_te)
    pallas = np.asarray(
        ps.stab_counts(
            *(jnp.asarray(a) for a in padded),
            jnp.asarray(q_tid), jnp.asarray(q_s), jnp.asarray(q_e),
            interpret=True,
        )
    )
    oracle = ps.stab_counts_host(*arrays)
    assert got.dtype == np.int32
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)
    if n:
        assert oracle.sum() > 0
    if tid_neg:
        assert np.all(got[q_tid < 0] == 0)


def test_pad_records_matches_jax_layout():
    rec_tid, rec_ts, rec_te, *_ = _case(8, 1500, 1)
    got = sc.pad_records(*(torch.from_numpy(a) for a in (rec_tid, rec_ts, rec_te)))
    exp = ps.pad_records(rec_tid, rec_ts, rec_te)
    for g, e in zip(got, exp):
        assert np.array_equal(g.numpy(), e)


def test_stab_counts_rejects_bad_inputs():
    arrays = [torch.from_numpy(a) for a in _case(9, 100, 4)]
    with pytest.raises(ValueError):
        sc.stab_counts(arrays[0].long(), *arrays[1:])
    with pytest.raises(ValueError):
        sc.stab_counts(*arrays[:5], arrays[5][:2])


# ── K-A's segmented count ───────────────────────────────────────────────

N_SEQS = 8
I32_MAX = 2**31 - 1


def _degenerate_case(seed, n, kind):
    """Records over targets 0..N_SEQS-1 (targets 2 and 5 empty) and queries
    with every degenerate shape: s > e, s == e, zero-length ranges at record
    ends, tid = -1, tid >= N_SEQS.  `kind` adds records with ts > te and
    zero-length ones ("malformed"), one record spanning the whole of
    target 0's segment ("long"), or records with target ids outside
    [0, N_SEQS) ("foreign_tids")."""
    rng = np.random.default_rng(seed)
    rec_tid = rng.choice([0, 1, 3, 4, 6, 7], n).astype(np.int32)
    rec_ts = rng.integers(0, 50_000, n).astype(np.int32)
    rec_te = (rec_ts + rng.integers(0, 3000, n)).astype(np.int32)
    if kind == "malformed" and n:
        bad = rng.random(n) < 0.2
        rec_te[bad] = rec_ts[bad] - rng.integers(1, 500, int(bad.sum()))
        zero = rng.random(n) < 0.1
        rec_te[zero] = rec_ts[zero]
        rec_te[:5] = rec_ts[:5]  # zero-length records, at least five
    if kind == "long" and n:
        rec_tid[0], rec_ts[0], rec_te[0] = 0, 0, 60_000
    if kind == "foreign_tids" and n:
        rec_tid[rng.random(n) < 0.2] = -3
        rec_tid[rng.random(n) < 0.1] = 1_000_000
    b = 600
    q_tid = rng.integers(-1, N_SEQS + 2, b).astype(np.int32)
    q_s = rng.integers(-100, 52_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(-3000, 10_000, b)).astype(np.int32)
    q_e[::9] = q_s[::9]  # s == e
    q_e[1::9] = q_s[1::9] - 1  # s > e by one
    if n:  # points at record ends
        pick = rng.integers(0, n, 40)
        q_tid[-80:-40], q_s[-80:-40] = rec_tid[pick], rec_te[pick]
        q_e[-80:-40] = rec_te[pick]
        q_tid[-40:], q_s[-40:] = rec_tid[pick], rec_ts[pick]
        q_e[-40:] = rec_ts[pick]
    if kind == "foreign_tids":
        q_tid[2::9] = -3
        q_tid[3::9] = 1_000_000
    q_e[4] = I32_MAX  # extreme bounds, on a real target
    q_s[5] = -(2**31)
    q_tid[4] = q_tid[5] = 0
    return rec_tid, rec_ts, rec_te, q_tid, q_s, q_e


def _sorted_layout(rec_tid, rec_ts, rec_te):
    """The engines' layout (segment t = target t, tgt_offsets by search)
    over records sorted as an index sorts them."""
    order = np.lexsort((rec_ts, rec_tid))
    tid, ts, te = rec_tid[order], rec_ts[order], rec_te[order]
    offs = np.searchsorted(tid, np.arange(N_SEQS + 1)).astype(np.int64)
    up = lambda a: torch.from_numpy(np.asarray(a, np.int32))  # noqa: E731
    return sc.engine_layout(ts, te, offs, up(offs), up(ts), up(te),
                            up(sc.compute_cummax_te(te, offs)))


def _pallas(arrays):
    rec_tid, rec_ts, rec_te, q_tid, q_s, q_e = arrays
    padded = ps.pad_records(rec_tid, rec_ts, rec_te)
    return np.asarray(ps.stab_counts(
        *(jnp.asarray(a) for a in padded),
        jnp.asarray(q_tid), jnp.asarray(q_s), jnp.asarray(q_e),
        interpret=True,
    ))


@pytest.mark.parametrize("layout", ["segmented", "engine"])
@pytest.mark.parametrize(
    "seed,n,kind",
    [
        (20, 3000, "plain"),  # degenerate queries over a clean index
        (21, 3000, "malformed"),  # records with ts > te: the window route
        (22, 1500, "long"),  # one record spanning a whole segment
        (23, 2000, "foreign_tids"),  # record ids outside [0, n_seqs)
        (24, 0, "plain"),  # empty record set
        (25, 1, "long"),  # one record
    ],
)
def test_segmented_count_matches_pallas_and_oracle(layout, seed, n, kind):
    arrays = _degenerate_case(seed, n, kind)
    rec_tid, rec_ts, rec_te, q_tid, q_s, q_e = arrays
    if layout == "engine" and kind == "foreign_tids":
        rec_tid = np.clip(rec_tid, 0, N_SEQS - 1)  # the engines' targets
        arrays = (rec_tid, *arrays[1:])
    lay = (sc.segmented_layout(*(torch.from_numpy(a) for a in arrays[:3]))
           if layout == "segmented" else _sorted_layout(*arrays[:3]))
    assert lay.wellformed == bool(np.all(rec_ts <= rec_te))
    got = sc.stab_counts_segmented(
        lay, *(torch.from_numpy(a) for a in (q_tid, q_s, q_e))).numpy()
    oracle = ps.stab_counts_host(*arrays)
    assert got.dtype == np.int32
    assert np.array_equal(got, oracle)
    assert np.array_equal(got, _pallas(arrays))
    assert np.array_equal(
        got, sc.stab_counts_plain(*(torch.from_numpy(a) for a in arrays)))
    assert np.all(got[(q_tid < 0) & (q_tid != -3)] == 0)
    if n > 100:  # the window route counts something (s > e queries)
        assert oracle.sum() > 0 and (oracle[q_s > q_e] > 0).any()


def test_segmented_layout_columns():
    rec_tid, rec_ts, rec_te, *_ = _degenerate_case(30, 2500, "malformed")
    lay = sc.segmented_layout(
        *(torch.from_numpy(a) for a in (rec_tid, rec_ts, rec_te)))
    assert lay.seg_tid.tolist() == sorted(set(rec_tid.tolist()))
    offs = lay.tgt_offsets.numpy()
    ts, te, cm, srt = (getattr(lay, k).numpy() for k in
                       ("t_start", "t_end", "cummax_te", "te_sorted"))
    assert offs[0] == 0 and offs[-1] == rec_tid.size
    assert lay.wellformed is False
    for i, t in enumerate(lay.seg_tid.tolist()):
        sl = slice(offs[i], offs[i + 1])
        mine = rec_tid == t
        assert np.all(np.diff(ts[sl]) >= 0)
        assert sorted(zip(ts[sl], te[sl])) == sorted(
            zip(rec_ts[mine], rec_te[mine]))
        assert np.array_equal(cm[sl], np.maximum.accumulate(te[sl]))
        assert np.array_equal(srt[sl], np.sort(te[sl]))
    clean = sc.segmented_layout(
        *(torch.from_numpy(a) for a in _degenerate_case(31, 50, "plain")[:3]))
    assert clean.wellformed is True


@pytest.mark.parametrize("kind", ["clean", "malformed"])
def test_engine_stab_counts_match_jax(kind):
    """TorchDeviceEngine and TorchPagedEngine count through the segmented
    layout they hold; equal to the JAX engine's Pallas count on an index
    with an empty target and, for "malformed", records with ts > te and one
    spanning a whole segment."""
    from impg_tpu.query.device import DeviceEngine
    from impg_tpu_torch.query.device import TorchDeviceEngine
    from impg_tpu_torch.query.paged import TorchPagedEngine

    text, _, _ = datagen.pangenome_paf(random.Random(5), n_seqs=6,
                                       seq_len=20_000, cross_links=3)
    index = index_from_text(text)
    r = index.records
    offs = index.tgt_offsets
    assert (np.diff(offs) > 0).all()
    if kind == "malformed":
        rng = np.random.default_rng(3)
        bad = rng.random(len(r)) < 0.4
        r.t_end[bad] = r.t_start[bad] // 2
        first = int(offs[1])
        r.t_start[first] = 0
        r.t_end[first] = 30_000
    n_seqs = len(index.seq_index)
    rng = np.random.default_rng(4)
    b = 400
    q_tid = rng.integers(-1, n_seqs + 2, b).astype(np.int32)
    q_s = rng.integers(0, 20_000, b).astype(np.int32)
    q_e = (q_s + rng.integers(-2000, 6000, b)).astype(np.int32)
    q_e[::7] = q_s[::7]
    q_e[1::7] = q_s[1::7] + 100
    ref = DeviceEngine(index).stab_counts(q_tid, q_s, q_e)
    assert ref.sum() > 0 and (ref[q_s > q_e] > 0).any()
    budget = max((index.arena.n_ops * 20 + len(r) * 24) // 4, 1 << 12)
    for eng in (TorchDeviceEngine(index, "cpu"),
                TorchPagedEngine(index, "cpu", hbm_budget_bytes=budget)):
        got = eng.stab_counts(q_tid, q_s, q_e)
        assert got.dtype == np.int32
        assert np.array_equal(got, ref), type(eng).__name__
        assert eng.stab_layout().wellformed == (kind == "clean")
        assert eng.stab_layout() is eng.stab_layout()  # built once
    assert np.array_equal(ref, ps.stab_counts_host(
        r.target_id, r.t_start, r.t_end, q_tid, q_s, q_e))


def test_stab_counts_has_no_query_cap():
    """The CUDA wrapper once refused more than 65,535 x 256 queries a call;
    the segmented kernel's 1-D grid takes any int32 count."""
    assert not hasattr(sc, "_MAX_QUERIES")
