"""Directed-alignment CIGAR arena: the TPU-native alignment representation.

The port's copy of impg_tpu/core/arena.py
(tests/test_torch_host.py holds the two equal).

The reference keeps CIGARs on disk and re-reads + re-walks them per projection
(impg.rs:495-530, 2760-2898).  Here every alignment is decoded ONCE into a flat
run tensor, and — because the index is bidirectional (each A->B alignment is
also queryable as B->A, impg.rs:1582-1605) — each alignment contributes up to
two *directed records*, each with its own run slice:

  - the forward entry uses the parsed runs as-is;
  - the swapped entry uses the inverted runs (I<->D swapped, order reversed on
    the reverse strand; reference: impg.rs:144-162).

For each directed record we precompute exclusive prefix sums over its runs:

  cum_t[i]   absolute target coordinate at the start of run i
  cum_q[i]   absolute query position at the start of run i, in walk order
             (starts at q_end and decreases on the reverse strand)
  cum_match / cum_mm / cum_icnt / cum_dcnt / cum_ibp / cum_dbp
             identity statistics before run i ('M' counts as match like the
             reference, impg.rs:2952)

With these resident, projecting a target range through an alignment becomes
two binary searches over cum_t plus closed-form boundary arithmetic, and
gap-compressed / block identity of the clipped slice are prefix-sum
differences with boundary corrections — no per-op walk, no sequence I/O.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.core import cigar


def segmented_exclusive_cumsum(
    values: np.ndarray, offsets: np.ndarray, base: np.ndarray
) -> np.ndarray:
    """Per-segment exclusive prefix sum, rebased to `base` per segment."""
    if values.size == 0:
        return np.zeros(0, dtype=np.int64)
    glob = np.cumsum(values, dtype=np.int64)
    glob = np.concatenate([np.zeros(1, np.int64), glob[:-1]])
    counts = np.diff(offsets)
    rebase = np.repeat(base.astype(np.int64) - glob[offsets[:-1]], counts)
    return glob + rebase


def _reverse_within_segments(n: int, offsets: np.ndarray) -> np.ndarray:
    """Index array that reverses each [offsets[k], offsets[k+1]) segment."""
    counts = np.diff(offsets)
    starts = np.repeat(offsets[:-1], counts)
    ends = np.repeat(offsets[1:], counts)
    i = np.arange(n, dtype=np.int64)
    return starts + (ends - 1 - i)


@dataclass
class DirectedRecords:
    """Struct-of-arrays over directed alignment records."""

    target_id: np.ndarray  # int32
    query_id: np.ndarray  # int32
    t_start: np.ndarray  # int32 — directed target span (forward coords)
    t_end: np.ndarray  # int32
    q_start: np.ndarray  # int32 — directed query span (forward coords)
    q_end: np.ndarray  # int32
    strand: np.ndarray  # int8: 0 forward, 1 reverse
    op_off: np.ndarray  # int64 into the arena
    op_cnt: np.ndarray  # int32
    rec_id: np.ndarray  # int32 original undirected record index
    is_reversed: np.ndarray  # bool — swapped-direction entry

    def __len__(self) -> int:
        return self.target_id.size

    @classmethod
    def concatenate(cls, parts: list["DirectedRecords"]) -> "DirectedRecords":
        return cls(
            **{
                name: np.concatenate([getattr(p, name) for p in parts])
                for name in cls.__dataclass_fields__
            }
        )

    def take(self, idx: np.ndarray) -> "DirectedRecords":
        return DirectedRecords(
            **{name: getattr(self, name)[idx] for name in self.__dataclass_fields__}
        )


class CigarArena:
    """Run arena with eager projection arrays and lazily-derived stats.

    Eager (every projection touches them — 20 B/run resident):
      runs          uint32 packed (op, len)
      cum_t         int32 — absolute target coord at run start
      cum_q         int32 — absolute query pos at run start (walk order)
      irun_before   int32 — contiguous 'I' runs immediately before
      irun_after    int32 — contiguous 'I' runs immediately after

    Lazy identity-statistics block (another 24 B/run, derived from `runs`
    on first access — only min-identity filtering and PAF/BEDPE stat
    output need it, the dominant `-o bed` path never does):
      cum_match / cum_mm / cum_icnt / cum_dcnt / cum_ibp / cum_dbp

    Laziness needs `seg_offsets` (the ordered per-record run-segment
    boundaries, n_segments+1 int64): the prefix sums restart per record.
    Constructors created by `build_directed` carry it; a v2 artifact or a
    direct construction may instead pass the stats arrays eagerly.
    """

    EAGER_FIELDS = ("runs", "cum_t", "cum_q", "irun_before", "irun_after")
    STATS_FIELDS = (
        "cum_match", "cum_mm", "cum_icnt", "cum_dcnt", "cum_ibp", "cum_dbp",
    )

    def __init__(
        self,
        runs,
        cum_t,
        cum_q,
        cum_match=None,
        cum_mm=None,
        cum_icnt=None,
        cum_dcnt=None,
        cum_ibp=None,
        cum_dbp=None,
        irun_before=None,
        irun_after=None,
        *,
        seg_offsets=None,
    ):
        self.runs = runs
        self.cum_t = cum_t
        self.cum_q = cum_q
        self.irun_before = irun_before
        self.irun_after = irun_after
        self._seg_offsets = seg_offsets
        stats = (cum_match, cum_mm, cum_icnt, cum_dcnt, cum_ibp, cum_dbp)
        if any(s is not None for s in stats):
            if any(s is None for s in stats):
                raise ValueError("stats arrays must be given together")
            self._stats = dict(zip(self.STATS_FIELDS, stats))
        else:
            self._stats = None

    # ── lazy stats ───────────────────────────────────────────────────
    @property
    def stats_materialized(self) -> bool:
        return self._stats is not None

    def attach_seg_offsets(self, seg_offsets: np.ndarray) -> None:
        self._seg_offsets = seg_offsets

    @property
    def seg_offsets(self):
        return self._seg_offsets

    def _ensure_stats(self) -> dict:
        if self._stats is None:
            if self._seg_offsets is None:
                raise RuntimeError(
                    "CigarArena stats requested but neither stats arrays "
                    "nor seg_offsets were provided"
                )
            self._stats = _build_stats(self.runs, self._seg_offsets)
        return self._stats

    def __getattr__(self, name):
        # Only reached when normal attribute lookup fails — i.e. the six
        # lazy stats fields.
        if name in CigarArena.STATS_FIELDS:
            return self._ensure_stats()[name]
        raise AttributeError(name)

    @property
    def n_ops(self) -> int:
        return self.runs.size

    def projection_kwargs(self, with_stats: bool = True) -> dict:
        """Arena arrays keyed for ops.projection.project_batch.

        `with_stats=False` returns only the eager projection core —
        callers running lean (interval-only) projections avoid
        materializing the 24 B/run stats block."""
        out = dict(
            runs=self.runs,
            cum_t=self.cum_t,
            cum_q=self.cum_q,
            irun_before=self.irun_before,
            irun_after=self.irun_after,
        )
        if with_stats:
            out.update(self._ensure_stats())
        return out

    @classmethod
    def empty(cls) -> "CigarArena":
        z = np.zeros(0, np.int32)
        return cls(
            np.zeros(0, np.uint32), z, z, z, z, z, z, z, z, z, z,
            seg_offsets=np.zeros(1, np.int64),
        )


def _build_stats(runs: np.ndarray, offsets: np.ndarray) -> dict:
    """Derive the identity-statistics prefix block from packed runs.

    Depends only on the runs and the ordered segment boundaries (the
    per-record prefix sums restart at zero), so it can run lazily long
    after the arena was built or loaded."""
    lens = cigar.run_len(runs).astype(np.int64)
    ops = cigar.run_op(runs)
    zeros = np.zeros(len(offsets) - 1, dtype=np.int64)
    is_match = (ops == cigar.OP_EQ) | (ops == cigar.OP_M)
    is_x = ops == cigar.OP_X
    is_i = ops == cigar.OP_I
    is_d = ops == cigar.OP_D

    def cum(vals):
        return segmented_exclusive_cumsum(vals, offsets, zeros).astype(np.int32)

    return dict(
        cum_match=cum(np.where(is_match, lens, 0)),
        cum_mm=cum(np.where(is_x, lens, 0)),
        cum_icnt=cum(is_i.astype(np.int64)),
        cum_dcnt=cum(is_d.astype(np.int64)),
        cum_ibp=cum(np.where(is_i, lens, 0)),
        cum_dbp=cum(np.where(is_d, lens, 0)),
    )


def _build_cums(
    runs: np.ndarray,
    offsets: np.ndarray,
    t_base: np.ndarray,
    q_base: np.ndarray,
    strand: np.ndarray,
) -> CigarArena:
    """Compute the eager per-run prefix arrays for a run arena.

    The identity-statistics block is NOT computed here — the returned
    arena derives it lazily from (runs, offsets) on first access."""
    lens = cigar.run_len(runs).astype(np.int64)
    ops = cigar.run_op(runs)
    tdelta = np.where(cigar.consumes_target(ops), lens, 0)
    counts = np.diff(offsets)
    sign = np.where(np.repeat(strand, counts) == 0, 1, -1)
    qdelta = np.where(cigar.consumes_query(ops), lens * sign, 0)
    is_i = ops == cigar.OP_I

    # Contiguous 'I'-run lengths around each run, segment-aware (used for the
    # boundary insertion inclusion rule of the reference walk).
    n_runs = runs.size
    idx = np.arange(n_runs, dtype=np.int64)
    seg_start = np.repeat(offsets[:-1], counts)
    seg_end = np.repeat(offsets[1:], counts)
    if n_runs:
        nonI_next = np.where(~is_i, idx + 1, 0)
        acc = np.maximum.accumulate(nonI_next)
        acc_excl = np.concatenate([np.zeros(1, np.int64), acc[:-1]])
        irun_before = (idx - np.maximum(seg_start, acc_excl)).astype(np.int32)
        big = np.int64(n_runs)
        nonI_at = np.where(~is_i, idx, big)
        nxt = np.minimum.accumulate(nonI_at[::-1])[::-1]
        nxt_excl = np.concatenate([nxt[1:], np.full(1, big)])
        irun_after = (np.minimum(seg_end, nxt_excl) - idx - 1).astype(np.int32)
    else:
        irun_before = np.zeros(0, np.int32)
        irun_after = np.zeros(0, np.int32)

    return CigarArena(
        runs=runs,
        cum_t=segmented_exclusive_cumsum(tdelta, offsets, t_base).astype(np.int32),
        cum_q=segmented_exclusive_cumsum(qdelta, offsets, q_base).astype(np.int32),
        irun_before=irun_before,
        irun_after=irun_after,
        seg_offsets=offsets.astype(np.int64),
    )


def build_directed(
    *,
    query_id: np.ndarray,
    q_start: np.ndarray,
    q_end: np.ndarray,
    target_id: np.ndarray,
    t_start: np.ndarray,
    t_end: np.ndarray,
    strand: np.ndarray,
    runs: np.ndarray,
    run_offsets: np.ndarray,
    bidirectional: bool = True,
) -> tuple[DirectedRecords, CigarArena]:
    """Build directed records + arena from parsed (undirected) alignments.

    Mirrors the reference's dual-entry index build (impg.rs:1535-1633): every
    alignment gets a forward entry; with `bidirectional`, non-self alignments
    also get a swapped entry projecting query->target through inverted runs.
    """
    n = query_id.size
    rec_ids = np.arange(n, dtype=np.int32)
    counts = np.diff(run_offsets).astype(np.int64)

    fwd = DirectedRecords(
        target_id=target_id.astype(np.int32),
        query_id=query_id.astype(np.int32),
        t_start=t_start.astype(np.int32),
        t_end=t_end.astype(np.int32),
        q_start=q_start.astype(np.int32),
        q_end=q_end.astype(np.int32),
        strand=strand.astype(np.int8),
        op_off=run_offsets[:-1].astype(np.int64),
        op_cnt=counts.astype(np.int32),
        rec_id=rec_ids,
        is_reversed=np.zeros(n, dtype=bool),
    )

    if not bidirectional:
        q_base = np.where(strand == 0, q_start, q_end).astype(np.int64)
        arena = _build_cums(runs, run_offsets, t_start.astype(np.int64), q_base, strand)
        return fwd, arena

    # Swapped entries for non-self alignments.
    swap_mask = query_id != target_id
    sidx = np.nonzero(swap_mask)[0]

    # Build inverted run arena for swapped records: swap I<->D globally, then
    # reverse run order inside reverse-strand segments.
    ops_all = cigar.run_op(runs)
    inv_ops = ops_all.copy()
    inv_ops[ops_all == cigar.OP_I] = cigar.OP_D
    inv_ops[ops_all == cigar.OP_D] = cigar.OP_I
    inv_runs_full = cigar.pack(cigar.run_len(runs), inv_ops.astype(np.uint32))

    # Gather the swapped records' runs into a new contiguous arena.
    sw_counts = counts[sidx]
    sw_offsets = np.concatenate(
        [np.zeros(1, np.int64), np.cumsum(sw_counts, dtype=np.int64)]
    )
    # Piecewise-contiguous gather built with the repeat/arange trick —
    # O(total) with no per-record Python work (multi-million-record builds).
    total_sw = int(sw_offsets[-1])
    if total_sw:
        starts = run_offsets[sidx].astype(np.int64)
        gather = (
            np.arange(total_sw, dtype=np.int64)
            - np.repeat(sw_offsets[:-1], sw_counts)
            + np.repeat(starts, sw_counts)
        )
    else:
        gather = np.zeros(0, np.int64)
    sw_runs = inv_runs_full[gather]
    # Reverse run order within reverse-strand swapped segments.
    rev_segs = np.nonzero(strand[sidx] == 1)[0]
    if rev_segs.size:
        rev_mask = np.zeros(len(sidx), dtype=bool)
        rev_mask[rev_segs] = True
        per_run_rev = np.repeat(rev_mask, sw_counts)
        rev_map = _reverse_within_segments(sw_runs.size, sw_offsets)
        idx = np.arange(sw_runs.size, dtype=np.int64)
        sw_runs = sw_runs[np.where(per_run_rev, rev_map, idx)]

    swapped = DirectedRecords(
        target_id=query_id[sidx].astype(np.int32),
        query_id=target_id[sidx].astype(np.int32),
        t_start=q_start[sidx].astype(np.int32),
        t_end=q_end[sidx].astype(np.int32),
        q_start=t_start[sidx].astype(np.int32),
        q_end=t_end[sidx].astype(np.int32),
        strand=strand[sidx].astype(np.int8),
        op_off=(sw_offsets[:-1] + runs.size).astype(np.int64),
        op_cnt=sw_counts.astype(np.int32),
        rec_id=rec_ids[sidx],
        is_reversed=np.ones(len(sidx), dtype=bool),
    )

    records = DirectedRecords.concatenate([fwd, swapped])

    all_runs = np.concatenate([runs, sw_runs])
    all_offsets = np.concatenate([run_offsets, run_offsets[-1] + sw_offsets[1:]])
    t_base = np.concatenate([t_start, q_start[sidx]]).astype(np.int64)
    q_base_fwd = np.where(strand == 0, q_start, q_end).astype(np.int64)
    q_base_sw = np.where(strand[sidx] == 0, t_start[sidx], t_end[sidx]).astype(np.int64)
    q_base = np.concatenate([q_base_fwd, q_base_sw])
    strand_all = np.concatenate([strand, strand[sidx]]).astype(np.int8)
    arena = _build_cums(all_runs, all_offsets, t_base, q_base, strand_all)
    return records, arena
