"""Native C++ transitive-query engine binding (the CPU baseline of record).

The port's copy of impg_tpu/query/host_native.py
(tests/test_torch_host.py holds the two equal).

`NativeHostEngine` runs full depth-limited transitive BFS walks in C++
(native/host_engine.cpp) with the exact semantics of
`engine.query_transitive_bfs_many`, including masked-region preload and
the gap-compressed min-identity gate (no CIGAR materialization, subsets
or approximate mode — those fall back).  Three cost models:

  * mode="paf"    — the reference's FULL default-path cost model: per
    projection, re-parse the record's whole ASCII CIGAR (the reference
    preads + byte-scans the cg:Z: field on every get_cigar_ops,
    impg.rs:495-530, :2935 parse_cigar_to_delta) then walk linearly.
    Generous to the reference (ASCII resident in RAM, no syscall/Vec
    alloc).  This is what BENCH reports `vs_baseline` against.
  * mode="walk"   — a STRONGER Rust proxy: interval-tree stab + the
    linear per-op run walk per projection (impg.rs:2760-2898) over
    pre-parsed resident runs — i.e. the reference design upgraded with
    our resident-arena layout (no ASCII re-parse).
  * mode="closed" — our own closed-form algorithm on CPU: the strongest
    known CPU implementation of the query (a harder baseline than the
    reference design), and what `--compute-engine auto` runs.

Both are exact: results equal the host/device engines row for row
(tests/test_host_native.py).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from impg_tpu_torch.query.engine import RowBlock

_bound = False

MODES = {"closed": 0, "walk": 1, "paf": 2}


def _lib():
    global _bound
    from impg_tpu_torch.io import native as native_mod

    lib = native_mod.load()
    if lib is None or not hasattr(lib, "he_create"):
        return None
    if not _bound:
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        lib.he_create.restype = ctypes.c_void_p
        lib.he_create.argtypes = [
            ctypes.c_int64, i32p, i32p, i32p, i32p, i8p, i64p, i32p,
            ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, u32p, i32p, i32p, i32p, i32p,
            i32p, i32p, i32p, i32p,
        ]
        lib.he_destroy.restype = None
        lib.he_destroy.argtypes = [ctypes.c_void_p]
        lib.he_run.restype = ctypes.c_int64
        lib.he_run.argtypes = [
            ctypes.c_void_p, i32p, i32p, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, i64p, i64p, i64p, i64p,
            ctypes.c_int64, ctypes.c_double, ctypes.c_int32, u8p,
            ctypes.c_int64, ctypes.c_int32,
        ]
        lib.he_build_cigar_text.restype = ctypes.c_int64
        lib.he_build_cigar_text.argtypes = [ctypes.c_void_p]
        lib.he_set_stats.restype = None
        lib.he_set_stats.argtypes = [ctypes.c_void_p, i32p, i32p, i32p, i32p]
        lib.he_set_tracepoints.restype = None
        lib.he_set_tracepoints.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, i64p, i32p, i32p, i64p, i64p,
            i32p, i32p,
        ]
        lib.he_walk_rows.restype = ctypes.c_int64
        lib.he_walk_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.he_fetch_walk.restype = None
        lib.he_fetch_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i32p, i32p, i32p, i32p, i32p,
            i32p,
        ]
        lib.he_clear.restype = None
        lib.he_clear.argtypes = [ctypes.c_void_p]
        lib.he_walk_offsets.restype = None
        lib.he_walk_offsets.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i64p,
        ]
        lib.he_fetch_all.restype = None
        lib.he_fetch_all.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, i64p, ctypes.c_int32,
            i32p, i32p, i32p, i32p, i32p, i32p,
        ]
        _bound = True
    return lib


class NativeHostEngine:
    """ctypes wrapper owning the borrowed index arrays for the C++ engine.

    `is_native_host` marks the object for `query_transitive_bfs_many`'s
    dispatch (duck-typed to avoid a circular import).  `mode`/`threads`
    set the default cost model and parallelism for dispatched runs:
    closed-form on all cores — the fastest executor measured for this
    pointer-chasing workload (see bench.py's executor survey).
    """

    is_native_host = True

    def __init__(self, index, mode: str = "closed", threads: int = 0):
        lib = _lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.mode = mode
        self.threads = threads or (os.cpu_count() or 1)
        self._lib = lib
        self._index = index
        self._tp_set = False
        r = index.records
        a = index.arena
        c = np.ascontiguousarray
        # Keep every borrowed buffer alive on self.  The identity-stat
        # prefix arrays are attached lazily (he_set_stats) only when a
        # min-identity run needs them — never for interval-only walks.
        self._keep = dict(
            tgt=c(r.target_id, np.int32),
            qid=c(r.query_id, np.int32),
            ts=c(r.t_start, np.int32),
            te=c(r.t_end, np.int32),
            strand=c(r.strand, np.int8),
            op_off=c(r.op_off, np.int64),
            op_cnt=c(r.op_cnt, np.int32),
            tgt_off=c(index.tgt_offsets, np.int64),
            seq_lens=c(index.seq_index.lengths_array(), np.int64),
            runs=c(a.runs, np.uint32),
            cum_t=c(a.cum_t, np.int32),
            cum_q=c(a.cum_q, np.int32),
            irb=c(a.irun_before, np.int32),
            ira=c(a.irun_after, np.int32),
        )
        self._stats_set = False
        k = self._keep
        dummy = np.zeros(0, np.int32)
        self._keep["stats_dummy"] = dummy
        self._h = lib.he_create(
            len(r), k["tgt"], k["qid"], k["ts"], k["te"], k["strand"],
            k["op_off"], k["op_cnt"], len(index.seq_index), k["tgt_off"],
            k["seq_lens"], a.n_ops, k["runs"], k["cum_t"], k["cum_q"],
            k["irb"], k["ira"], dummy, dummy, dummy, dummy,
        )

    def _ensure_stats(self) -> None:
        """Attach the identity-stat prefix arrays (materializing the
        arena's lazy stats block on first min-identity use)."""
        if self._stats_set:
            return
        a = self._index.arena
        c = np.ascontiguousarray
        self._keep.update(
            cum_match=c(a.cum_match, np.int32),
            cum_mm=c(a.cum_mm, np.int32),
            cum_icnt=c(a.cum_icnt, np.int32),
            cum_dcnt=c(a.cum_dcnt, np.int32),
        )
        k = self._keep
        self._lib.he_set_stats(
            self._h, k["cum_match"], k["cum_mm"], k["cum_icnt"],
            k["cum_dcnt"],
        )
        self._stats_set = True

    def close(self):
        if self._h is not None:
            self._lib.he_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass

    def run_counts(
        self,
        targets,
        max_depth: int = 2,
        min_transitive_len: int = 101,
        min_distance_between_ranges: int = 10,
        mode: str | None = None,
        threads: int = 0,
        masked_regions=None,
        min_identity: float | None = None,
        subset_seq_ok=None,
        min_output_length: int | None = None,
        approximate: bool = False,
    ) -> int:
        """Run walks, return total result rows (rows retained natively).

        `masked_regions` is the engine's dict[int, SortedRanges] contract
        (partition's pre-visited bookkeeping): flattened into
        (qid, s, e, entry_seq_len) preload rows; an entry with no ranges
        becomes one zero-length row so its sequence_length still governs
        later inserts (mirrors query/engine.py:847-859)."""
        mode = mode or self.mode
        threads = threads or self.threads
        if approximate and not self._tp_set:
            self._attach_tracepoints()
        if min_identity is not None:
            self._ensure_stats()
        if mode == "paf":
            self.ensure_paf_baseline()
        q_tid = np.ascontiguousarray([t[0] for t in targets], np.int32)
        q_s = np.ascontiguousarray([t[1] for t in targets], np.int32)
        q_e = np.ascontiguousarray([t[2] for t in targets], np.int32)
        m_qid, m_s, m_e, m_len = [], [], [], []
        if masked_regions is not None:
            for sid, sr in masked_regions.items():
                slen = int(getattr(sr, "sequence_length", 0))
                if not sr.ranges:
                    m_qid.append(int(sid))
                    m_s.append(0)
                    m_e.append(0)
                    m_len.append(slen)
                for ms, me in sr.ranges:
                    m_qid.append(int(sid))
                    m_s.append(int(ms))
                    m_e.append(int(me))
                    m_len.append(slen)
        return int(
            self._lib.he_run(
                self._h, q_tid, q_s, q_e, len(targets), max_depth,
                min_transitive_len, min_distance_between_ranges,
                MODES[mode], threads,
                0 if masked_regions is None else 1,
                np.ascontiguousarray(m_qid, np.int64),
                np.ascontiguousarray(m_s, np.int64),
                np.ascontiguousarray(m_e, np.int64),
                np.ascontiguousarray(m_len, np.int64),
                len(m_qid),
                -1.0 if min_identity is None else float(min_identity),
                0 if subset_seq_ok is None else 1,
                np.ascontiguousarray(
                    subset_seq_ok if subset_seq_ok is not None else [],
                    np.uint8,
                ),
                -1 if min_output_length is None else int(min_output_length),
                1 if approximate else 0,
            )
        )

    def ensure_paf_baseline(self) -> int:
        """Materialize the resident ASCII CIGAR blob for mode="paf" (the
        reference's default-path cost model: full cg:Z: byte re-parse per
        projection, impg.rs:495-530 + :2935).  Idempotent; returns the
        blob size in bytes."""
        return int(self._lib.he_build_cigar_text(self._h))

    def _attach_tracepoints(self):
        """Upload the tracepoint arena (built on demand) for approximate
        runs; borrowed buffers join the keep-alive dict."""
        tp = self._index.ensure_tracepoints()
        c = np.ascontiguousarray
        r = self._index.records
        self._keep.update(
            tp_off=c(tp.seg_off, np.int64),
            tp_nseg=c(tp.n_seg, np.int32),
            tp_qb=c(tp.q_bound, np.int32),
            tp_diffs=c(tp.pre_diffs, np.int64),
            tp_aligned=c(tp.pre_aligned, np.int64),
            q_start=c(r.q_start, np.int32),
            q_end=c(r.q_end, np.int32),
        )
        k = self._keep
        self._lib.he_set_tracepoints(
            self._h, int(tp.spacing), k["tp_off"], k["tp_nseg"],
            k["tp_qb"], k["tp_diffs"], k["tp_aligned"], k["q_start"],
            k["q_end"],
        )
        self._tp_set = True

    def run(self, targets, **kw) -> list[RowBlock]:
        """Run walks and fetch per-walk RowBlocks (engine-identical).

        One batched fetch for the whole run — per-walk ctypes calls and
        allocations cost ~3x the BFS itself on large batches."""
        self.run_counts(targets, **kw)
        n_walks = len(targets)
        off = np.zeros(n_walks + 1, np.int64)
        self._lib.he_walk_offsets(self._h, n_walks, off)
        total = int(off[-1])
        cols = [np.empty(total, np.int32) for _ in range(6)]
        if total:
            self._lib.he_fetch_all(
                self._h, n_walks, off, self.threads, *cols
            )
        # Columns stay int32 views into the batch arrays: coordinates fit
        # by format, and widening to int64 costs more than the BFS itself
        # (page-faulting fresh allocations, see columnar_ops docstring).
        out = [
            RowBlock(*(c[off[w]:off[w + 1]] for c in cols))
            for w in range(n_walks)
        ]
        self._lib.he_clear(self._h)
        return out
