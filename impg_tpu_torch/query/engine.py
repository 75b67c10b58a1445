"""Query engine: plain stab+project queries and transitive closure walks.

The port's copy of impg_tpu/query/engine.py (tests/test_torch_host.py holds
the two equal); its device engines are the port's (query/device.py,
query/paged.py), reached through the `device_engine` argument.

Semantics mirror the reference engine:
  - plain query: impg.rs:1852-1928 (self row first, then projected overlaps)
  - transitive BFS: impg.rs:2311-2597 (per-depth batched projection, visited
    SortedRanges bookkeeping, frontier sort+merge)
  - transitive DFS: impg.rs:2057-2309 (LIFO stack, per-pop sort+merge)

The projection of every candidate in a depth is one batched closed-form call
(ops/projection_np.py); only the visited-range bookkeeping is sequential, as it
is order-dependent in the reference too.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.intervals import SortedRanges
from impg_tpu_torch.index.impg_index import ImpgIndex
from impg_tpu_torch.ops import projection_np as projection


@dataclass(slots=True)
class Row:
    """One adjusted interval: query side, optional CIGAR runs, target side.

    `q_first > q_last` encodes a reverse-strand hit, as in the reference.
    """

    q_id: int
    q_first: int
    q_last: int
    cigar: Optional[np.ndarray]  # packed uint32 runs, or None
    t_id: int
    t_first: int
    t_last: int


def _self_row(target_id: int, start: int, end: int, store_cigar: bool) -> Row:
    runs = (
        cigar.pack(
            np.array([end - start], np.int64), np.array([cigar.OP_EQ], np.uint32)
        )
        if store_cigar
        else None
    )
    return Row(target_id, start, end, runs, target_id, start, end)


def _project_approx(
    index: ImpgIndex,
    cand: np.ndarray,
    rng_s: np.ndarray,
    rng_e: np.ndarray,
    min_identity: Optional[float],
):
    """Approximate (tracepoint) projection (impg.rs:1317); returns an object
    with the same fields the bookkeeping reads, plus an ok mask."""
    from impg_tpu_torch.index import tracepoints as tp_mod

    tp = index.ensure_tracepoints() if index.tp is None else index.tp
    res = tp_mod.project_batch_approx(
        tp, index.records, cand, np.asarray(rng_s), np.asarray(rng_e)
    )
    ok = np.asarray(res.valid)
    if min_identity is not None:
        gci = tp_mod.gap_compressed_identity_approx(res)
        ok = ok & (gci >= min_identity)
    return res, ok


def _approx_cigar_runs(res, i: int) -> Optional[np.ndarray]:
    """2-run approx CIGAR [m=, xX] for identity stats (impg.rs:1481-1489)."""
    m = int(round(float(res.matches[i])))
    x = int(round(float(res.mismatches[i])))
    lens, ops = [], []
    if m > 0:
        lens.append(m)
        ops.append(cigar.OP_EQ)
    if x > 0:
        lens.append(x)
        ops.append(cigar.OP_X)
    if not lens:
        return np.zeros(0, np.uint32)
    return cigar.pack(np.asarray(lens, np.int64), np.asarray(ops, np.uint32))


def _project(
    index: ImpgIndex,
    cand: np.ndarray,
    rng_s: np.ndarray,
    rng_e: np.ndarray,
    min_identity: Optional[float],
):
    res = projection.project_batch(
        **index.arena.projection_kwargs(),
        op_off=index.records.op_off[cand],
        op_cnt=index.records.op_cnt[cand],
        t_start=index.records.t_start[cand],
        t_end=index.records.t_end[cand],
        strand=index.records.strand[cand],
        range_start=rng_s.astype(np.int32),
        range_end=rng_e.astype(np.int32),
    )
    ok = np.asarray(res.valid)
    if min_identity is not None:
        gci = projection.gap_compressed_identity(res)
        ok = ok & (gci >= min_identity)
    return res, ok


def _materialize_cigar(index: ImpgIndex, rec_idx: int, res, i: int) -> np.ndarray:
    row = dict(
        first_run=res.first_run[i],
        last_run=res.last_run[i],
        first_clip=res.first_clip[i],
        last_rem=res.last_rem[i],
    )
    return projection.clipped_runs(
        index.arena.runs, int(index.records.op_off[rec_idx]), row
    )


def query(
    index: ImpgIndex,
    target_id: int,
    range_start: int,
    range_end: int,
    store_cigar: bool = False,
    min_identity: Optional[float] = None,
    approximate: bool = False,
) -> list[Row]:
    """Single-hop query: the input range plus every projected overlap."""
    results = [_self_row(target_id, range_start, range_end, store_cigar)]
    cand = index.stab(target_id, range_start, range_end)
    if cand.size == 0:
        return results
    rng_s = np.full(cand.size, range_start, np.int64)
    rng_e = np.full(cand.size, range_end, np.int64)
    project = _project_approx if approximate else _project
    res, ok = project(index, cand, rng_s, rng_e, min_identity)
    for i in np.nonzero(ok)[0]:
        k = int(cand[i])
        if store_cigar:
            runs = (
                _approx_cigar_runs(res, i)
                if approximate
                else _materialize_cigar(index, k, res, i)
            )
        else:
            runs = None
        results.append(
            Row(
                q_id=int(index.records.query_id[k]),
                q_first=int(res.pq_start[i]),
                q_last=int(res.pq_end[i]),
                cigar=runs,
                t_id=target_id,
                t_first=int(res.pt_start[i]),
                t_last=int(res.pt_end[i]),
            )
        )
    return results


def _visited_entry(
    visited: dict[int, SortedRanges],
    index: ImpgIndex,
    sid: int,
    masked_none: bool,
) -> SortedRanges:
    entry = visited.get(sid)
    if entry is None:
        length = index.seq_index.get_len_from_id(sid) if masked_none else 0
        entry = SortedRanges(length or 0, 0)
        visited[sid] = entry
    return entry


def _too_close(ranges: SortedRanges, lo: int, hi: int, min_distance: int) -> bool:
    """Proximity pre-check before visited insertion (impg.rs:2505-2545)."""
    if min_distance <= 0:
        return False
    from bisect import bisect_left

    idx = bisect_left(ranges.ranges, lo, key=lambda r: r[0])
    if idx > 0 and abs(lo - ranges.ranges[idx - 1][1]) < min_distance:
        return True
    if idx < len(ranges.ranges) and abs(ranges.ranges[idx][0] - hi) < min_distance:
        return True
    return False


@dataclass(slots=True)
class RowBlock:
    """Columnar result block: one walk's rows as flat arrays.

    The engine's native result currency — rows stay tensors end to end
    (the reference materializes Vec<AdjustedInterval>; here the SoA block
    is the equivalent).  `to_rows()` materializes Row objects for
    consumers that need them.
    """

    q_id: np.ndarray
    q_first: np.ndarray
    q_last: np.ndarray
    t_id: np.ndarray
    t_first: np.ndarray
    t_last: np.ndarray

    def __len__(self) -> int:
        return int(self.q_id.size)

    def to_rows(self) -> list[Row]:
        return [
            Row(q, a, b, None, t, ts, te)
            for q, a, b, t, ts, te in zip(
                self.q_id.tolist(), self.q_first.tolist(),
                self.q_last.tolist(), self.t_id.tolist(),
                self.t_first.tolist(), self.t_last.tolist(),
            )
        ]

    def __iter__(self):
        return iter(self.to_rows())


def _rows_to_block(rows: list[Row]) -> RowBlock:
    return RowBlock(
        q_id=np.asarray([r.q_id for r in rows], np.int64),
        q_first=np.asarray([r.q_first for r in rows], np.int64),
        q_last=np.asarray([r.q_last for r in rows], np.int64),
        t_id=np.asarray([r.t_id for r in rows], np.int64),
        t_first=np.asarray([r.t_first for r in rows], np.int64),
        t_last=np.asarray([r.t_last for r in rows], np.int64),
    )


_vb_bound = False


def _vb_lib():
    """The native visited-book (native/visited.cpp), or None.

    Binds the ctypes signatures on first use; the Python SortedRanges path
    below stays as the fallback and semantics oracle.
    """
    global _vb_bound
    from impg_tpu_torch.io import native as native_mod

    lib = native_mod.load()
    if lib is None or not hasattr(lib, "vb_create"):
        return None
    if not _vb_bound:
        import ctypes

        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.vb_create.restype = ctypes.c_void_p
        lib.vb_create.argtypes = [ctypes.c_int64, i64p, ctypes.c_int32]
        lib.vb_destroy.restype = None
        lib.vb_destroy.argtypes = [ctypes.c_void_p]
        lib.vb_preload.restype = None
        lib.vb_preload.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 5
        lib.vb_seed.restype = ctypes.c_int64
        lib.vb_seed.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [i64p, i64p,
                                                        ctypes.c_int64]
        )
        lib.vb_seed_many.restype = None
        lib.vb_seed_many.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p, ctypes.c_int64,
        ]
        lib.vb_process.restype = None
        lib.vb_process.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vb_process32.restype = None
        lib.vb_process32.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, i32p, u8p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vb_frontier_fetch32.restype = None
        lib.vb_frontier_fetch32.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, i32p,
        ]
        lib.vb_frontier_size.restype = ctypes.c_int64
        lib.vb_frontier_size.argtypes = [ctypes.c_void_p]
        lib.vb_frontier_fetch.restype = None
        lib.vb_frontier_fetch.argtypes = [
            ctypes.c_void_p, i64p, i64p, i64p, i64p,
        ]
        lib.vb_frontier_clear.restype = None
        lib.vb_frontier_clear.argtypes = [ctypes.c_void_p]
        _vb_bound = True
    return lib


def _merge_frontier(ranges: list[tuple[int, int, int]]) -> list[tuple[int, int, int]]:
    """Sort by (id, start) and merge overlapping/contiguous same-id ranges."""
    if not ranges:
        return ranges
    ranges.sort(key=lambda r: (r[0], r[1]))
    out = [ranges[0]]
    for r in ranges[1:]:
        last = out[-1]
        if last[0] == r[0] and last[2] >= r[1]:
            out[-1] = (last[0], last[1], max(last[2], r[2]))
        else:
            out.append(r)
    return out


def _depth_step_host(
    index: ImpgIndex,
    current: list[tuple[int, int, int]],
    min_identity,
    approximate: bool = False,
):
    """Stab+project a whole BFS depth on host; returns pair arrays.

    Output arrays are ordered frontier-major then t_start (the same order the
    device path produces), with fields matching DeviceEngine.query_batch.
    """
    cand_parts, ov_s_parts, ov_e_parts, src_parts = [], [], [], []
    for fi, (cur_tid, cs, ce) in enumerate(current):
        cand = index.stab(cur_tid, cs, ce)
        if cand.size == 0:
            continue
        ov_s = np.maximum(cs, index.records.t_start[cand].astype(np.int64))
        ov_e = np.minimum(ce, index.records.t_end[cand].astype(np.int64))
        keep = ov_s < ov_e
        cand_parts.append(cand[keep])
        ov_s_parts.append(ov_s[keep])
        ov_e_parts.append(ov_e[keep])
        src_parts.append(np.full(int(keep.sum()), fi, np.int64))
    if not cand_parts:
        return None
    cand = np.concatenate(cand_parts)
    ov_s = np.concatenate(ov_s_parts)
    ov_e = np.concatenate(ov_e_parts)
    src = np.concatenate(src_parts)
    project = _project_approx if approximate else _project
    res, ok = project(index, cand, ov_s, ov_e, min_identity)
    sel = np.nonzero(ok)[0]
    out = dict(
        pair_rec=cand[sel],
        pair_q=src[sel],
        query_id=index.records.query_id[cand[sel]],
        pq_start=np.asarray(res.pq_start)[sel],
        pq_end=np.asarray(res.pq_end)[sel],
        pt_start=np.asarray(res.pt_start)[sel],
        pt_end=np.asarray(res.pt_end)[sel],
    )
    if approximate:
        out["approx_matches"] = np.asarray(res.matches)[sel]
        out["approx_mismatches"] = np.asarray(res.mismatches)[sel]
    else:
        out.update(
            first_run=np.asarray(res.first_run)[sel],
            last_run=np.asarray(res.last_run)[sel],
            first_clip=np.asarray(res.first_clip)[sel],
            last_rem=np.asarray(res.last_rem)[sel],
        )
    return out



def _step_cigar(index: ImpgIndex, step: dict, i: int, k: int):
    """Materialize a row's CIGAR from a depth-step record (exact slice or
    2-run approximate stats)."""
    if "approx_matches" in step:
        class _R:
            matches = step["approx_matches"]
            mismatches = step["approx_mismatches"]
        return _approx_cigar_runs(_R, i)
    return projection.clipped_runs(
        index.arena.runs,
        int(index.records.op_off[k]),
        {f: step[f][i] for f in
         ("first_run", "last_run", "first_clip", "last_rem")},
    )


def _filter_step(out: dict, min_identity, approximate: bool):
    """Shared per-chunk identity filtering/renaming (exact host-f64
    semantics); returns None when nothing survives."""
    if approximate:
        if "matches" in out:
            out["approx_matches"] = out.pop("matches")
            out["approx_mismatches"] = out.pop("mismatches")
        if min_identity is not None:
            m = out["approx_matches"].astype(np.float64)
            total = m + out["approx_mismatches"].astype(np.float64)
            gci = np.where(total > 0, m / np.maximum(total, 1.0), 0.0)
            keep = gci >= min_identity
            out = {k: (v[keep] if np.ndim(v) else v) for k, v in out.items()}
        return out if out["pair_q"].size else None
    if out["pair_q"].size == 0:
        return None
    if min_identity is not None:
        m = out["matches"].astype(np.float64)
        total = (
            out["matches"] + out["mismatches"] + out["i_count"] + out["d_count"]
        ).astype(np.float64)
        gci = np.where(total > 0, m / np.maximum(total, 1.0), 0.0)
        keep = gci >= min_identity
        out = {k: (v[keep] if np.ndim(v) else v) for k, v in out.items()}
    return out


LEAN_FIELDS = (
    "pair_q", "valid", "query_id", "pq_start", "pq_end",
    "pt_start", "pt_end",
)
LEAN_STATS_FIELDS = LEAN_FIELDS + (
    "matches", "mismatches", "i_count", "d_count",
)


def _depth_step_device_stream(
    device_engine, current: list[tuple[int, int, int]],
    min_identity, approximate: bool = False,
    fields: tuple | None = None,
):
    """Yield filtered per-chunk step dicts for a whole BFS depth; the
    caller's bookkeeping on chunk i overlaps later chunks' device work.

    `current` is either a list of (tid, s, e) tuples or a 3-tuple of
    parallel arrays (the native BFS passes its frontier columns directly).
    """
    if isinstance(current, tuple):
        q_tid, q_s, q_e = (np.asarray(c, np.int32) for c in current)
    else:
        q_tid = np.asarray([c[0] for c in current], np.int32)
        q_s = np.asarray([c[1] for c in current], np.int32)
        q_e = np.asarray([c[2] for c in current], np.int32)
    for out in device_engine.query_batch_stream(
        q_tid, q_s, q_e, clip_overlap=True, approximate=approximate,
        fields=fields,
    ):
        step = _filter_step(out, min_identity, approximate)
        if step is not None:
            yield step


def _depth_step_device(
    device_engine, index: ImpgIndex, current: list[tuple[int, int, int]],
    min_identity, approximate: bool = False,
):
    """Stab+project a whole BFS depth with the batched device engine."""
    q_tid = np.asarray([c[0] for c in current], np.int32)
    q_s = np.asarray([c[1] for c in current], np.int32)
    q_e = np.asarray([c[2] for c in current], np.int32)
    out = device_engine.query_batch(
        q_tid, q_s, q_e, clip_overlap=True, approximate=approximate
    )
    if approximate:
        out["approx_matches"] = out.pop("matches")
        out["approx_mismatches"] = out.pop("mismatches")
        if min_identity is not None:
            m = out["approx_matches"].astype(np.float64)
            total = m + out["approx_mismatches"].astype(np.float64)
            gci = np.where(total > 0, m / np.maximum(total, 1.0), 0.0)
            keep = gci >= min_identity
            out = {k: (v[keep] if np.ndim(v) else v) for k, v in out.items()}
        return out if out["pair_q"].size else None
    if out["pair_q"].size == 0:
        return None
    if min_identity is not None:
        # Exact f64 identity filter on host (device stats are exact ints).
        m = out["matches"].astype(np.float64)
        total = (
            out["matches"] + out["mismatches"] + out["i_count"] + out["d_count"]
        ).astype(np.float64)
        gci = np.where(total > 0, m / np.maximum(total, 1.0), 0.0)
        keep = gci >= min_identity
        out = {k: (v[keep] if np.ndim(v) else v) for k, v in out.items()}
    return out


def query_transitive_bfs(
    index: ImpgIndex,
    target_id: int,
    range_start: int,
    range_end: int,
    masked_regions: Optional[dict[int, SortedRanges]] = None,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    min_output_length: Optional[int] = None,
    store_cigar: bool = False,
    min_identity: Optional[float] = None,
    subset_match: Optional[Callable[[str], bool]] = None,
    device_engine=None,
    approximate: bool = False,
) -> list[Row]:
    # Single walk = the many-walk engine with one target: shares the
    # native bookkeeping and lean-transfer paths (partition/refine/render
    # all funnel through here).
    return query_transitive_bfs_many(
        index,
        [(target_id, range_start, range_end)],
        masked_regions=masked_regions,
        max_depth=max_depth,
        min_transitive_len=min_transitive_len,
        min_distance_between_ranges=min_distance_between_ranges,
        min_output_length=min_output_length,
        store_cigar=store_cigar,
        min_identity=min_identity,
        subset_match=subset_match,
        device_engine=device_engine,
        approximate=approximate,
    )[0]


def _query_transitive_bfs_legacy(
    index: ImpgIndex,
    target_id: int,
    range_start: int,
    range_end: int,
    masked_regions: Optional[dict[int, SortedRanges]] = None,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    min_output_length: Optional[int] = None,
    store_cigar: bool = False,
    min_identity: Optional[float] = None,
    subset_match: Optional[Callable[[str], bool]] = None,
    device_engine=None,
    approximate: bool = False,
) -> list[Row]:
    """Retired standalone single-walk implementation (semantics oracle)."""
    masked_none = masked_regions is None
    visited: dict[int, SortedRanges] = (
        {k: v.clone() for k, v in masked_regions.items()} if masked_regions else {}
    )

    seed_ranges = _visited_entry(visited, index, target_id, masked_none).insert(
        (range_start, range_end)
    )

    results: list[Row] = []
    for s, e in seed_ranges:
        runs = (
            cigar.pack(np.array([e - s], np.int64), np.array([cigar.OP_EQ], np.uint32))
            if store_cigar
            else None
        )
        results.append(Row(target_id, s, e, runs, target_id, s, e))

    current: list[tuple[int, int, int]] = [
        (target_id, s, e) for s, e in seed_ranges if abs(s - e) >= min_transitive_len
    ]

    depth = 0
    while current and (max_depth == 0 or depth < max_depth):
        # ── batched stab + projection over the whole depth ──
        use_device = device_engine is not None and (
            not approximate
            or getattr(device_engine, "supports_approximate", False)
        )
        step = (
            _depth_step_device(
                device_engine, index, current, min_identity, approximate
            )
            if use_device
            else _depth_step_host(index, current, min_identity, approximate)
        )
        if step is None:
            break

        # ── sequential bookkeeping, in frontier order ──
        next_ranges: list[tuple[int, int, int]] = []
        pair_q = step["pair_q"]
        for i in range(pair_q.size):
            k = int(step["pair_rec"][i])
            q_id = int(step["query_id"][i])
            if subset_match is not None and q_id != target_id:
                name = index.seq_index.get_name(q_id)
                if name is None or not subset_match(name):
                    continue
            aq_s = int(step["pq_start"][i])
            aq_e = int(step["pq_end"][i])
            cur_tid = current[int(pair_q[i])][0]
            length = abs(aq_e - aq_s)
            if min_output_length is None or length >= min_output_length:
                runs = _step_cigar(index, step, i, k) if store_cigar else None
                results.append(
                    Row(
                        q_id=q_id,
                        q_first=aq_s,
                        q_last=aq_e,
                        cigar=runs,
                        t_id=cur_tid,
                        t_first=int(step["pt_start"][i]),
                        t_last=int(step["pt_end"][i]),
                    )
                )
            if q_id != cur_tid:
                ranges = _visited_entry(visited, index, q_id, masked_none)
                lo, hi = (aq_s, aq_e) if aq_s <= aq_e else (aq_e, aq_s)
                if _too_close(ranges, lo, hi, min_distance_between_ranges):
                    continue
                for ns, ne in ranges.insert((aq_s, aq_e)):
                    if abs(ne - ns) >= min_transitive_len:
                        next_ranges.append((q_id, ns, ne))

        depth += 1
        current = _merge_frontier(next_ranges)

    return results


def query_transitive_bfs_many(
    index: ImpgIndex,
    targets: list[tuple[int, int, int]],
    masked_regions: Optional[dict[int, SortedRanges]] = None,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    min_output_length: Optional[int] = None,
    store_cigar: bool = False,
    min_identity: Optional[float] = None,
    subset_match: Optional[Callable[[str], bool]] = None,
    device_engine=None,
    approximate: bool = False,
    columnar: bool = False,
) -> list[list[Row]]:
    """Run many independent transitive BFS walks, batched per depth.

    Each (target_id, start, end) walk keeps its own visited set and result
    list (identical semantics to `query_transitive_bfs`), but every depth's
    stab+projection for ALL walks runs as one batched step — the device
    round-trip is amortized across walks.  This is the batched `-b BED -x`
    hot path; the reference processes BED rows serially (main.rs:7435).

    `columnar=True` (CIGAR-less walks only) returns one RowBlock per walk
    instead of Row lists — results stay flat arrays with no per-row Python
    object construction.
    """
    if columnar and store_cigar:
        raise ValueError("columnar results do not carry CIGARs")
    if getattr(device_engine, "is_native_host", False):
        # Full-native dispatch: the C++ engine (query/host_native.py) runs
        # the whole BFS — stab, closed-form or tracepoint-approximate
        # projection, visited bookkeeping, masked-region preload,
        # min-identity / subset / min-output-length gates — with zero
        # Python per row.  Only CIGAR materialization falls back to the
        # engines below.
        if not store_cigar:
            subset_ok = None
            if subset_match is not None:
                subset_ok = np.zeros(len(index.seq_index), np.uint8)
                for sid in range(len(index.seq_index)):
                    name = index.seq_index.get_name(sid)
                    subset_ok[sid] = 1 if (name and subset_match(name)) else 0
            blocks = device_engine.run(
                targets, max_depth=max_depth,
                min_transitive_len=min_transitive_len,
                min_distance_between_ranges=min_distance_between_ranges,
                masked_regions=masked_regions,
                min_identity=min_identity,
                subset_seq_ok=subset_ok,
                min_output_length=min_output_length,
                approximate=approximate,
            )
            return blocks if columnar else [b.to_rows() for b in blocks]
        device_engine = None
    lib = _vb_lib()
    if lib is not None:
        return _bfs_many_native(
            lib, index, targets, masked_regions, max_depth,
            min_transitive_len, min_distance_between_ranges,
            min_output_length, store_cigar, min_identity, subset_match,
            device_engine, approximate, columnar,
        )
    masked_none = masked_regions is None
    n_walks = len(targets)
    visited: list[dict[int, SortedRanges]] = [
        ({k: v.clone() for k, v in masked_regions.items()} if masked_regions else {})
        for _ in range(n_walks)
    ]
    results: list[list[Row]] = [[] for _ in range(n_walks)]
    current: list[tuple[int, int, int, int]] = []  # (walk, tid, s, e)

    for w, (target_id, range_start, range_end) in enumerate(targets):
        seed = _visited_entry(visited[w], index, target_id, masked_none).insert(
            (range_start, range_end)
        )
        for s, e in seed:
            runs = (
                cigar.pack(
                    np.array([e - s], np.int64), np.array([cigar.OP_EQ], np.uint32)
                )
                if store_cigar
                else None
            )
            results[w].append(Row(target_id, s, e, runs, target_id, s, e))
            if abs(s - e) >= min_transitive_len:
                current.append((w, target_id, s, e))

    depth = 0
    while current and (max_depth == 0 or depth < max_depth):
        flat = [(tid, s, e) for (_, tid, s, e) in current]
        use_device = device_engine is not None and (
            not approximate
            or getattr(device_engine, "supports_approximate", False)
        )
        if use_device:
            # Streaming: each chunk's bookkeeping overlaps the device
            # compute/transfer of the depth's remaining chunks.  Without
            # CIGAR materialization the transfer drops run-slice
            # descriptors (and identity stats when unfiltered).
            step_iter = _depth_step_device_stream(
                device_engine, flat, min_identity, approximate,
                fields=None if store_cigar else (
                    LEAN_STATS_FIELDS
                    if min_identity is not None
                    else LEAN_FIELDS
                ),
            )
        else:
            one = _depth_step_host(index, flat, min_identity, approximate)
            step_iter = iter([one] if one is not None else [])

        next_per_walk: list[list[tuple[int, int, int]]] = [
            [] for _ in range(n_walks)
        ]
        for step in step_iter:
            # Batch-convert device arrays to Python lists once —
            # per-element numpy scalar indexing dominates this loop
            # otherwise.
            rows_iter = enumerate(
                zip(
                    step["pair_q"].tolist(),
                    step["query_id"].tolist(),
                    step["pq_start"].tolist(),
                    step["pq_end"].tolist(),
                    step["pt_start"].tolist(),
                    step["pt_end"].tolist(),
                )
            )
            for i, (fi, q_id, aq_s, aq_e, pt_s, pt_e) in rows_iter:
                w, cur_tid, _, _ = current[fi]
                if subset_match is not None and q_id != targets[w][0]:
                    name = index.seq_index.get_name(q_id)
                    if name is None or not subset_match(name):
                        continue
                if (
                    min_output_length is None
                    or abs(aq_e - aq_s) >= min_output_length
                ):
                    runs = None
                    if store_cigar:
                        k = int(step["pair_rec"][i])
                        runs = _step_cigar(index, step, i, k)
                    results[w].append(
                        Row(q_id, aq_s, aq_e, runs, cur_tid, pt_s, pt_e)
                    )
                if q_id != cur_tid:
                    ranges = _visited_entry(
                        visited[w], index, q_id, masked_none
                    )
                    lo, hi = (aq_s, aq_e) if aq_s <= aq_e else (aq_e, aq_s)
                    if _too_close(
                        ranges, lo, hi, min_distance_between_ranges
                    ):
                        continue
                    for ns, ne in ranges.insert((aq_s, aq_e)):
                        if abs(ne - ns) >= min_transitive_len:
                            next_per_walk[w].append((q_id, ns, ne))

        depth += 1
        current = []
        for w in range(n_walks):
            for tid, s, e in _merge_frontier(next_per_walk[w]):
                current.append((w, tid, s, e))

    if columnar:
        return [_rows_to_block(rows) for rows in results]
    return results


def _bfs_many_native(
    lib,
    index: ImpgIndex,
    targets: list[tuple[int, int, int]],
    masked_regions,
    max_depth: int,
    min_transitive_len: int,
    min_distance_between_ranges: int,
    min_output_length: Optional[int],
    store_cigar: bool,
    min_identity: Optional[float],
    subset_match,
    device_engine,
    approximate: bool,
    columnar: bool = False,
) -> list:
    """query_transitive_bfs_many with the order-dependent visited
    bookkeeping in C++ (native/visited.cpp): per step chunk, ONE native
    call replaces the per-hit too-close/insert Python loop; frontier
    entries come back as flat arrays and merge vectorized.  With
    `columnar` the per-hit Row loop disappears too — result columns
    accumulate as arrays and partition per walk at the end (RowBlock)."""
    n_walks = len(targets)
    seq_lens = np.ascontiguousarray(
        index.seq_index.lengths_array().astype(np.int64)
    )
    h = lib.vb_create(
        len(index.seq_index), seq_lens, 1 if masked_regions is None else 0
    )
    try:
        results: list[list[Row]] = [[] for _ in range(n_walks)]
        # Columnar accumulators: one run of column-chunk lists per depth
        # (w, q_id, q_first, q_last, t_id, t_first, t_last) — each run is
        # walk-sorted by construction, which _partition_columnar exploits.
        depth_runs: list[tuple[list, ...]] = []
        # Per-sequence subset pass/fail, computed once (vectorized gate).
        subset_ok = None
        if subset_match is not None:
            subset_ok = np.zeros(len(index.seq_index), bool)
            for sid in range(len(index.seq_index)):
                name = index.seq_index.get_name(sid)
                subset_ok[sid] = bool(name) and subset_match(name)
        # 32-bit host pipeline: the device engine already returns int32
        # columns, so int32-native bookkeeping skips a widening pass per
        # chunk.  Falls back to the 64-bit ABI for outsized coordinates.
        use32 = (
            seq_lens.size == 0 or int(seq_lens.max()) < 2**31
        ) and all(
            -(2**31) < v < 2**31 for t in targets for v in t
        )
        dt = np.int32 if use32 else np.int64
        vb_process = lib.vb_process32 if use32 else lib.vb_process
        vb_fetch = (
            lib.vb_frontier_fetch32 if use32 else lib.vb_frontier_fetch
        )

        def as_dt(a):
            if a.dtype == dt and a.flags.c_contiguous:
                return a
            return np.ascontiguousarray(a, dt)

        target_of_walk = np.asarray([t[0] for t in targets], dt)

        if masked_regions:
            for w in range(n_walks):
                for sid, sr in masked_regions.items():
                    slen = int(getattr(sr, "sequence_length", 0))
                    if not sr.ranges:
                        # Materialize the (possibly empty) mask entry so
                        # its sequence_length governs later inserts, like a
                        # Python-side clone would.
                        lib.vb_preload(h, w, int(sid), 0, 0, slen)
                    for ms, me in sr.ranges:
                        lib.vb_preload(
                            h, w, int(sid), int(ms), int(me), slen
                        )
        # Bulk seed: one native call inserts every walk's seed range and
        # returns all uncovered sub-ranges via the frontier accumulator.
        lib.vb_frontier_clear(h)
        lib.vb_seed_many(
            h,
            np.ascontiguousarray(np.arange(n_walks, dtype=np.int64)),
            np.ascontiguousarray(
                np.asarray([t[0] for t in targets], np.int64)
            ),
            np.ascontiguousarray(
                np.asarray([t[1] for t in targets], np.int64)
            ),
            np.ascontiguousarray(
                np.asarray([t[2] for t in targets], np.int64)
            ),
            n_walks,
        )
        m = int(lib.vb_frontier_size(h))
        sw_arr = np.zeros(m, dt)
        st_arr = np.zeros(m, dt)
        ss_arr = np.zeros(m, dt)
        se_arr = np.zeros(m, dt)
        if m:
            vb_fetch(h, sw_arr, st_arr, ss_arr, se_arr)
        lib.vb_frontier_clear(h)
        if not columnar:
            for w, tid, s, e in zip(
                sw_arr.tolist(), st_arr.tolist(), ss_arr.tolist(),
                se_arr.tolist(),
            ):
                runs = (
                    cigar.pack(
                        np.array([e - s], np.int64),
                        np.array([cigar.OP_EQ], np.uint32),
                    )
                    if store_cigar
                    else None
                )
                results[w].append(Row(tid, s, e, runs, tid, s, e))
        keep = np.abs(se_arr - ss_arr) >= min_transitive_len
        cur_w = sw_arr[keep]
        cur_t = st_arr[keep]
        cur_s = ss_arr[keep]
        cur_e = se_arr[keep]

        log = logging.getLogger("impg_tpu_torch.engine")
        depth = 0
        while cur_w.size and (max_depth == 0 or depth < max_depth):
            t_depth = time.perf_counter()
            n_front = int(cur_w.size)
            use_device = device_engine is not None and (
                not approximate
                or getattr(device_engine, "supports_approximate", False)
            )
            if use_device:
                step_iter = _depth_step_device_stream(
                    device_engine, (cur_t, cur_s, cur_e), min_identity,
                    approximate,
                    fields=None if store_cigar else (
                        LEAN_STATS_FIELDS
                        if min_identity is not None
                        else LEAN_FIELDS
                    ),
                )
            else:
                flat = list(
                    zip(cur_t.tolist(), cur_s.tolist(), cur_e.tolist())
                )
                one = _depth_step_host(index, flat, min_identity, approximate)
                step_iter = iter([one] if one is not None else [])

            lib.vb_frontier_clear(h)
            d_cols: tuple[list, ...] = tuple([] for _ in range(7))
            for step in step_iter:
                pair_q = np.asarray(step["pair_q"])
                qid = as_dt(np.asarray(step["query_id"]))
                aqs = as_dt(np.asarray(step["pq_start"]))
                aqe = as_dt(np.asarray(step["pq_end"]))
                w_arr = cur_w[pair_q]
                cur_tid_arr = cur_t[pair_q]
                hit_idx = None
                if subset_ok is not None:
                    keep = subset_ok[qid] | (qid == target_of_walk[w_arr])
                    hit_idx = np.nonzero(keep)[0]
                    pair_q, qid, aqs, aqe, w_arr, cur_tid_arr = (
                        pair_q[hit_idx], qid[hit_idx], aqs[hit_idx],
                        aqe[hit_idx], w_arr[hit_idx], cur_tid_arr[hit_idx],
                    )
                book = np.ascontiguousarray(qid != cur_tid_arr).view(np.uint8)
                vb_process(
                    h,
                    as_dt(w_arr),
                    qid,
                    aqs,
                    aqe,
                    book,
                    qid.size,
                    min_distance_between_ranges,
                    min_transitive_len,
                )
                # Row emission.
                pts = np.asarray(step["pt_start"])
                pte = np.asarray(step["pt_end"])
                if hit_idx is not None:
                    pts, pte = pts[hit_idx], pte[hit_idx]
                if columnar:
                    if min_output_length is not None:
                        m = np.abs(aqe - aqs) >= min_output_length
                        cols = (
                            w_arr[m], qid[m], aqs[m], aqe[m],
                            cur_tid_arr[m],
                            as_dt(np.asarray(pts[m])),
                            as_dt(np.asarray(pte[m])),
                        )
                    else:
                        # Copy retained columns: compacted step arrays are
                        # VIEWS into the chunk's full result matrix, and
                        # accumulating views would pin every cap-wide
                        # matrix until the end of the query.
                        cols = (
                            w_arr, qid, aqs, aqe, cur_tid_arr,
                            as_dt(np.asarray(pts)),
                            as_dt(np.asarray(pte)),
                        )
                        cols = tuple(
                            c.copy() if c.base is not None else c
                            for c in cols
                        )
                    for acc, col in zip(d_cols, cols):
                        acc.append(col)
                elif store_cigar or min_output_length is not None:
                    src = (
                        hit_idx.tolist()
                        if hit_idx is not None
                        else range(qid.size)
                    )
                    for j, i in enumerate(src):
                        a, b = int(aqs[j]), int(aqe[j])
                        if (
                            min_output_length is not None
                            and abs(b - a) < min_output_length
                        ):
                            continue
                        runs = None
                        if store_cigar:
                            k = int(step["pair_rec"][i])
                            runs = _step_cigar(index, step, i, k)
                        results[int(w_arr[j])].append(
                            Row(
                                int(qid[j]), a, b, runs,
                                int(cur_tid_arr[j]), int(pts[j]),
                                int(pte[j]),
                            )
                        )
                else:
                    for w, q, a, b, ct, ts, te in zip(
                        w_arr.tolist(), qid.tolist(), aqs.tolist(),
                        aqe.tolist(), cur_tid_arr.tolist(), pts.tolist(),
                        pte.tolist(),
                    ):
                        results[w].append(Row(q, a, b, None, ct, ts, te))

            if columnar and d_cols[0]:
                depth_runs.append(d_cols)
            # Vectorized frontier sort + merge: entries are disjoint per
            # (walk, seq) book by construction (each uncovered sub-range is
            # inserted before the next hit), so merging only joins touching
            # neighbors (same contract as _merge_frontier).
            m = int(lib.vb_frontier_size(h))
            depth += 1
            if not m:
                cur_w = np.zeros(0, dt)
                continue
            fw = np.zeros(m, dt)
            fq = np.zeros(m, dt)
            fs = np.zeros(m, dt)
            fe = np.zeros(m, dt)
            vb_fetch(h, fw, fq, fs, fe)
            order = np.lexsort((fs, fq, fw))
            fw, fq, fs, fe = fw[order], fq[order], fs[order], fe[order]
            same = (fw[1:] == fw[:-1]) & (fq[1:] == fq[:-1])
            new = np.concatenate([[True], (~same) | (fs[1:] > fe[:-1])])
            last = np.concatenate([new[1:], [True]])
            cur_w = fw[new]
            cur_t = fq[new]
            cur_s = fs[new]
            cur_e = fe[last]
            log.debug(
                "depth %d: %d ranges -> %d frontier in %.3fs",
                depth, n_front, cur_w.size, time.perf_counter() - t_depth,
            )

        if columnar:
            return _partition_columnar(
                n_walks, (sw_arr, st_arr, ss_arr, se_arr), depth_runs
            )
        return results
    finally:
        lib.vb_destroy(h)


def _partition_columnar(n_walks, seeds, depth_runs) -> list[RowBlock]:
    """Split accumulated result columns into per-walk RowBlocks (seed rows
    first, then hits in emission order — matching the Row-list layout).

    Each run (the seeds, then one run per BFS depth) is already sorted by
    walk — the frontier is lexsorted by (walk, seq, start) and chunks
    stream in frontier order — so each run splits into per-walk contiguous
    segments (searchsorted boundaries) and assembly is ONE vectorized
    multi-slice gather: no global sort, no random scatter.  `seeds` is a
    (w, tid, s, e) array tuple; each depth run is a tuple of 7
    column-chunk lists (w, q_id, q_first, q_last, t_id, t_first, t_last).
    """
    runs = []
    sw, st, ss, se = seeds
    if sw.size:
        runs.append((sw, st, ss, se, st, ss, se))
    for d_cols in depth_runs:
        if d_cols[0]:
            runs.append(tuple(np.concatenate(c) for c in d_cols))
    if not runs:
        z = np.zeros(0, np.int64)
        return [RowBlock(z, z, z, z, z, z) for _ in range(n_walks)]

    walk_edges = np.arange(n_walks + 1, dtype=np.int64)
    seg_lo = []  # per run: [n_walks + 1] segment boundaries into the run
    run_base = []
    off = 0
    for i, r in enumerate(runs):
        w_r = r[0]
        if w_r.size and np.any(w_r[1:] < w_r[:-1]):  # safety net
            order = np.argsort(w_r, kind="stable")
            r = tuple(c[order] for c in r)
            runs[i] = r
            w_r = r[0]
        seg_lo.append(np.searchsorted(w_r, walk_edges))
        run_base.append(off)
        off += w_r.size

    # Segment table in output order (walk-major, run-minor): source start
    # in the concatenated runs + length, then the classic repeat/arange
    # trick builds the piecewise-contiguous gather index in O(n).
    n_runs = len(runs)
    src_start = np.empty((n_walks, n_runs), np.int64)
    seg_len = np.empty((n_walks, n_runs), np.int64)
    for i in range(n_runs):
        src_start[:, i] = seg_lo[i][:-1] + run_base[i]
        seg_len[:, i] = np.diff(seg_lo[i])
    src_start = src_start.ravel()
    seg_len = seg_len.ravel()
    total = off
    out_off = np.zeros(seg_len.size, np.int64)
    np.cumsum(seg_len[:-1], out=out_off[1:])
    gather = (
        np.arange(total, dtype=np.int64)
        - np.repeat(out_off, seg_len)
        + np.repeat(src_start, seg_len)
    )
    out_cols = [
        np.concatenate([r[c + 1] for r in runs])[gather] for c in range(6)
    ]
    walk_tot = seg_len.reshape(n_walks, n_runs).sum(axis=1)
    base = np.zeros(n_walks + 1, np.int64)
    np.cumsum(walk_tot, out=base[1:])
    return [
        RowBlock(*(col[lo:hi] for col in out_cols))
        for lo, hi in zip(base[:-1].tolist(), base[1:].tolist())
    ]


def query_transitive_dfs(
    index: ImpgIndex,
    target_id: int,
    range_start: int,
    range_end: int,
    masked_regions: Optional[dict[int, SortedRanges]] = None,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    min_output_length: Optional[int] = None,
    store_cigar: bool = False,
    min_identity: Optional[float] = None,
    subset_match: Optional[Callable[[str], bool]] = None,
) -> list[Row]:
    masked_none = masked_regions is None
    visited: dict[int, SortedRanges] = (
        {k: v.clone() for k, v in masked_regions.items()} if masked_regions else {}
    )
    seed_ranges = _visited_entry(visited, index, target_id, masked_none).insert(
        (range_start, range_end)
    )

    results: list[Row] = []
    stack: list[tuple[int, int, int, int]] = []
    for s, e in seed_ranges:
        runs = (
            cigar.pack(np.array([e - s], np.int64), np.array([cigar.OP_EQ], np.uint32))
            if store_cigar
            else None
        )
        results.append(Row(target_id, s, e, runs, target_id, s, e))
        if abs(s - e) >= min_transitive_len:
            stack.append((target_id, s, e, 0))

    while stack:
        cur_tid, cs, ce, depth = stack.pop()
        if max_depth > 0 and depth >= max_depth:
            continue
        cand = index.stab(cur_tid, cs, ce)
        if cand.size:
            ov_s = np.maximum(cs, index.records.t_start[cand].astype(np.int64))
            ov_e = np.minimum(ce, index.records.t_end[cand].astype(np.int64))
            keep = ov_s < ov_e
            cand, ov_s, ov_e = cand[keep], ov_s[keep], ov_e[keep]
        if cand.size:
            res, ok = _project(index, cand, ov_s, ov_e, min_identity)
            for i in np.nonzero(ok)[0]:
                k = int(cand[i])
                q_id = int(index.records.query_id[k])
                if subset_match is not None and q_id != target_id:
                    name = index.seq_index.get_name(q_id)
                    if name is None or not subset_match(name):
                        continue
                aq_s = int(res.pq_start[i])
                aq_e = int(res.pq_end[i])
                length = abs(aq_e - aq_s)
                if min_output_length is None or length >= min_output_length:
                    results.append(
                        Row(
                            q_id=q_id,
                            q_first=aq_s,
                            q_last=aq_e,
                            cigar=_materialize_cigar(index, k, res, i)
                            if store_cigar
                            else None,
                            t_id=cur_tid,
                            t_first=int(res.pt_start[i]),
                            t_last=int(res.pt_end[i]),
                        )
                    )
                if q_id != cur_tid:
                    ranges = _visited_entry(visited, index, q_id, masked_none)
                    lo, hi = (aq_s, aq_e) if aq_s <= aq_e else (aq_e, aq_s)
                    if _too_close(ranges, lo, hi, min_distance_between_ranges):
                        continue
                    for ns, ne in ranges.insert((aq_s, aq_e)):
                        if abs(ne - ns) >= min_transitive_len:
                            stack.append((q_id, ns, ne, depth + 1))

        # Sort + merge the pending stack (reference: impg.rs:2289-2305).
        stack.sort(key=lambda r: (r[0], r[1]))
        merged: list[tuple[int, int, int, int]] = []
        for item in stack:
            if merged and merged[-1][0] == item[0] and merged[-1][2] >= item[1]:
                prev = merged[-1]
                merged[-1] = (prev[0], prev[1], max(prev[2], item[2]), prev[3])
            else:
                merged.append(item)
        stack = merged

    return results
