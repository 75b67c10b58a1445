"""Device-resident batched query execution on a CUDA card.

Counterpart of impg_tpu/query/device.py.  The index lives on the device as
flat int32 tensors (`TorchDeviceIndex`); a batch of B query ranges is
answered by three hand-written kernels and two pieces of torch glue:

  1. K-B `windows_offsets` (csrc/windows.cu): per query, the candidate
     window [win_lo, win_lo + k) over the (target, t_start)-sorted records,
     from two binary searches (t_start > q_e, and the per-target prefix max
     of t_end >= q_s), and in the same launch the exclusive int64 cumsum of
     k, each query's lane offset.
  2. Glue (`DepthFront`): the queries go up in one copy and the offsets come
     back in one; the host cuts the batch into chunks of at most
     `lane_budget` lanes.
  3. K-C `project_lanes` (csrc/project_lanes.cu): one thread per exact lane
     (candidate record x query), the hit gate, the transitive walkers' clip
     and the closed-form projection (ops/projection.py) fused; it writes a
     valid byte and the requested RESULT_FIELDS rows.
  4. K-D `compact` (csrc/compact.cu): order-preserving stream compaction of
     the valid lanes into [n_fields, n_hits] in one launch (a decoupled
     look-back), then one device->host copy.

Approximate (tracepoint) walks replace step 3 with K-E `project_approx`
(csrc/project_approx.cu): the same exact lanes, hit gate and clip, then the
tracepoint closed form of ops/approx.py over the index's tracepoint columns
(interleaved on the device: `tracepoint_tensors`).

`stats -r/-b` region depth is K-A `stab_count` (csrc/stab_count.cu, through
ops/stab_count.py) over the resident record columns, with the t_end values
sorted within each target segment beside them (`stab_layout`).

Hits therefore come out query-major, then in ascending record order, like
both JAX paths (windowed and slotted).  Lanes are enumerated exactly, so the
JAX engine's k_max / cap doubling ladders and its windowed / slotted split
(which bound recompiles) have no counterpart.

Every kernel has a plain-torch twin here or in ops/; a wrapper runs the twin
for CPU tensors and launches its kernel (or raises) for CUDA tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from impg_tpu_torch import kernels
from impg_tpu_torch.ops import approx, projection
from impg_tpu_torch.ops.stab_count import (
    StabLayout,
    compute_cummax_te,
    engine_layout,
    stab_counts_segmented,
)
from impg_tpu_torch.ops.xfer import (
    as_i32,
    check_device,
    upload_i32,
    upload_i32_columns,
)

# Output fields of a query step, in the JAX engine's row order
# (impg_tpu/query/device.py:RESULT_FIELDS).
RESULT_FIELDS = (
    "pair_rec",
    "pair_q",
    "valid",
    "query_id",
    "pq_start",
    "pq_end",
    "pt_start",
    "pt_end",
    "first_run",
    "last_run",
    "first_clip",
    "last_rem",
    "matches",
    "mismatches",
    "i_count",
    "d_count",
    "i_bp",
    "d_bp",
)
STATS_FIELDS = ("matches", "mismatches", "i_count", "d_count", "i_bp", "d_bp")
_STATS_MASK = sum(1 << RESULT_FIELDS.index(f) for f in STATS_FIELDS)
_COMPACT_TILE = 4096  # lanes per tile of csrc/compact.cu (kTile)
_MAX_LANES = 2**31 - 1
# Lanes per K-C launch: bounds the [n_fields, lanes] scratch (18 fields x
# 2^24 lanes x 4 B = 1.2 GB) and keeps lane indices far inside int32.
LANE_BUDGET = 1 << 24


def _iters_for(n: int) -> int:
    return max(1, int(np.ceil(np.log2(n + 1))))


def field_mask(fields) -> int:
    """Bit i set for RESULT_FIELDS[i] in `fields` ("valid" excluded: the
    kernels keep it as its own byte array)."""
    m = 0
    for f in fields:
        if f != "valid":
            m |= 1 << RESULT_FIELDS.index(f)
    return m


def mask_fields(mask: int) -> list[str]:
    """Row order of a field mask: RESULT_FIELDS order."""
    return [f for i, f in enumerate(RESULT_FIELDS) if (mask >> i) & 1]


@dataclass
class TorchDeviceIndex:
    """Index tensors resident on one device (all int32)."""

    target_id: torch.Tensor  # [N]
    t_start: torch.Tensor  # [N]
    t_end: torch.Tensor  # [N]
    cummax_te: torch.Tensor  # [N] prefix max of t_end within target segment
    strand: torch.Tensor  # [N]
    query_id: torch.Tensor  # [N]
    op_off: torch.Tensor  # [N]
    op_cnt: torch.Tensor  # [N]
    tgt_offsets: torch.Tensor  # [n_seqs + 1]
    # PROJECTION_CORE (+ STATS_KEYS once uploaded) in `arena_tensors`'
    # layout; runs bit-cast.
    arena: dict
    n_records: int
    search_iters: int  # 2**iters > max op_cnt
    window_iters: int  # 2**iters > max records per target
    device: torch.device
    tp: dict | None = None  # TP_KEYS, for approximate (tracepoint) walks
    tp_spacing: int = 0

    RECORD_KEYS = (
        "target_id", "t_start", "t_end", "strand", "query_id", "op_off",
        "op_cnt",
    )
    PROJECTION_CORE = ("runs", "cum_t", "cum_q", "irun_before", "irun_after")
    # The PROJECTION_CORE arrays that K-C reads together at a boundary run,
    # interleaved on the device (`arena_tensors`).
    RUN_KEYS = ("runs", "cum_q", "irun_before", "irun_after")
    STATS_KEYS = (
        "cum_match", "cum_mm", "cum_icnt", "cum_dcnt", "cum_ibp", "cum_dbp",
    )
    # Tracepoint columns, named as in the JAX DeviceIndex.tp: per record
    # seg_off, n_seg, q_start, q_end; per boundary q_bound, pre_diffs,
    # pre_aligned (index/tracepoints.py).
    TP_KEYS = (
        "seg_off", "n_seg", "q_bound", "pre_diffs", "pre_aligned", "q_start",
        "q_end",
    )
    # On the device they are the columns of two tensors
    # (`tracepoint_tensors`): the per-record ones, then the per-boundary ones.
    TP_RECORD_KEYS = ("seg_off", "n_seg", "q_start", "q_end")
    TP_BOUND_KEYS = ("q_bound", "pre_diffs", "pre_aligned")

    @classmethod
    def from_arrays(cls, arrays: dict, device, tp: dict | None = None,
                    tp_spacing: int = 0) -> "TorchDeviceIndex":
        """Upload numpy arrays: RECORD_KEYS, `tgt_offsets`, the arena arrays
        present (PROJECTION_CORE, STATS_KEYS; the rest can follow through
        `upload_arena`), `cummax_te` (derived when absent), and the TP_KEYS
        columns `tp` on a grid of `tp_spacing` (int64 prefixes cast to int32
        as the JAX upload does: they are sums within one record)."""
        dev = check_device(device)
        if "runs" in arrays:
            _check_arena_size(arrays)
        if tp is not None and np.asarray(tp["q_bound"]).size >= 2**31:
            raise ValueError("tracepoint table too large for int32 offsets")
        t_end = np.asarray(arrays["t_end"])
        tgt_offsets = np.asarray(arrays["tgt_offsets"])
        cummax = arrays.get("cummax_te")
        if cummax is None:
            cummax = compute_cummax_te(t_end, tgt_offsets)
        op_cnt = np.asarray(arrays["op_cnt"])
        tree = np.diff(tgt_offsets)
        up = lambda a: upload_i32(np.asarray(a), dev)  # noqa: E731
        arena = arena_tensors(
            arrays, [k for k in cls.PROJECTION_CORE + cls.STATS_KEYS
                     if k in arrays], dev,
        )
        return cls(
            **{k: up(arrays[k]) for k in cls.RECORD_KEYS},
            cummax_te=up(cummax),
            tgt_offsets=up(tgt_offsets),
            arena=arena,
            n_records=int(t_end.size),
            search_iters=_iters_for(int(op_cnt.max()) if op_cnt.size else 1),
            window_iters=_iters_for(int(tree.max()) if tree.size else 1),
            device=dev,
            tp=None if tp is None else tracepoint_tensors(tp, dev),
            tp_spacing=int(tp_spacing) if tp is not None else 0,
        )

    @classmethod
    def build(cls, index, device,
              with_tracepoints: bool = False) -> "TorchDeviceIndex":
        """Upload an ImpgIndex, leaving the six identity-stats arena arrays
        (6/11 of the arena bytes) for `upload_stats`.  `with_tracepoints`
        adds the tracepoint columns of `index.tp` whatever its spacing, built
        at the default spacing when the index has none (the rule of the JAX
        DeviceIndex, which keeps this engine, the JAX one and the native one
        on one spacing), and leaves the whole CIGAR arena for
        `upload_arena`: approximate walks never read it."""
        r = index.records
        arrays = dict(**{k: getattr(r, k) for k in cls.RECORD_KEYS},
                      tgt_offsets=index.tgt_offsets)
        tp = tp_spacing = None
        if with_tracepoints:
            arena = index.tp if index.tp is not None else index.ensure_tracepoints()
            tp = {k: getattr(arena, k) for k in cls.TP_KEYS[:5]}
            tp.update(q_start=r.q_start, q_end=r.q_end)
            tp_spacing = arena.spacing
        else:
            arrays.update(index.arena.projection_kwargs(with_stats=False))
        return cls.from_arrays(arrays, device, tp, tp_spacing)

    def upload_arena(self, arena_arrays: dict) -> None:
        """Upload the PROJECTION_CORE arena arrays (exact projection)."""
        _check_arena_size(arena_arrays)
        self.arena.update(arena_tensors(arena_arrays, self.PROJECTION_CORE,
                                        self.device))

    def upload_stats(self, arena_arrays: dict) -> None:
        self.arena.update(arena_tensors(arena_arrays, self.STATS_KEYS,
                                        self.device))

    def nbytes(self) -> int:
        ts = [getattr(self, k) for k in self.RECORD_KEYS]
        ts += [self.cummax_te, self.tgt_offsets, *self.arena.values()]
        ts += list((self.tp or {}).values())
        return sum(t.numel() * t.element_size() for t in ts)


def arena_tensors(arrays: dict, keys, device) -> dict:
    """The arena arrays named in `keys` (whole groups of them) on `device`,
    in the layout K-C reads: `cum_t`, which the run searches probe, as an
    array of its own; the RUN_KEYS (runs, cum_q, irun_before, irun_after)
    as the columns of one int32 [n_runs, 4] tensor and the STATS_KEYS as
    those of one [n_runs, 6] tensor.  Interleaved, the values K-C needs at a
    boundary run come in one 16-byte load (and the six stats in three
    8-byte ones) where separate arrays cost a 32-byte sector each; the
    plain twin reads the column views as arrays."""
    out = {}
    for group in (("cum_t",), TorchDeviceIndex.RUN_KEYS,
                  TorchDeviceIndex.STATS_KEYS):
        present = [k for k in group if k in keys]
        if not present:
            continue
        if len(present) != len(group):
            raise ValueError(f"arena arrays {group} upload together")
        if len(group) == 1:
            out[group[0]] = upload_i32(np.asarray(arrays[group[0]]), device)
            continue
        t = upload_i32_columns([arrays[k] for k in group], device)
        out.update({k: t[:, i] for i, k in enumerate(group)})
    return out


def tracepoint_tensors(tp: dict, device) -> dict:
    """The TP_KEYS columns of `tp` on `device`, in the layout K-E reads:
    the TP_RECORD_KEYS (seg_off, n_seg, q_start, q_end) as the columns of
    one int32 [n_records, 4] tensor, the TP_BOUND_KEYS (q_bound, pre_diffs,
    pre_aligned) as those of one [n_bound, 3] tensor.  A record's four
    words then come in one 16-byte load, and the boundary rows K-E reads at
    a segment's two ends in two to four 32-byte sectors where seven arrays
    cost about ten; no separate copy stays resident, and the plain twin
    reads the column views as arrays.  int64 prefixes are cast to int32 as
    the JAX upload does (they are sums within one record)."""
    out = {}
    for group in (TorchDeviceIndex.TP_RECORD_KEYS,
                  TorchDeviceIndex.TP_BOUND_KEYS):
        t = upload_i32_columns(
            [np.asarray(tp[k]).astype(np.int32, copy=False) for k in group],
            device,
        )
        out.update({k: t[:, i] for i, k in enumerate(group)})
    return {k: out[k] for k in TorchDeviceIndex.TP_KEYS}


def _columns_base(columns: dict, group) -> int:
    """Pointer to the [n, len(group)] tensor behind `group`'s column views,
    checked to be the layout that `arena_tensors` or `tracepoint_tensors`
    makes."""
    base = columns[group[0]]
    for i, k in enumerate(group):
        t = columns[k]
        if (t.stride() != (len(group),)
                or t.data_ptr() != base.data_ptr() + 4 * i):
            raise ValueError(f"arrays {group} must be the interleaved "
                             "columns of one tensor")
    return base.data_ptr()


def _check_arena_size(arena_arrays: dict) -> None:
    if np.asarray(arena_arrays["runs"]).size >= 2**31:
        raise ValueError("arena too large for int32 offsets")


def _check_i32(name, t, n=None, dtype=torch.int32):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D {dtype} tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected length {n}, got {t.shape[0]}")


def _device_of(*ts) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# ── K-B: candidate windows and lane offsets ─────────────────────────────

# Threads a block of csrc/windows.cu (kThreads): one query each, and one
# scratch status word a block.
_WINDOWS_THREADS = 128


def stab_windows_plain(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e,
                       window_iters: int):
    """Plain twin of K-B's windows: (win_lo, k) int32 [B]; k = 0 for tid
    outside [0, n_seqs)."""
    n_seqs = tgt_offsets.shape[0] - 1
    n_rec = t_start.shape[0]
    zero = torch.zeros_like(q_tid)
    if n_seqs <= 0 or n_rec == 0:
        return zero, zero.clone()
    ok = (q_tid >= 0) & (q_tid < n_seqs)
    tid_c = q_tid.clamp(0, n_seqs - 1).long()
    seg_lo = tgt_offsets[tid_c]
    seg_n = tgt_offsets[tid_c + 1] - seg_lo

    def gate(arr, m):
        return arr[(seg_lo + m).long().clamp(0, n_rec - 1)]

    cut = projection._bisect(seg_n, lambda m: gate(t_start, m) > q_e,
                             window_iters)
    lo2 = projection._bisect(seg_n, lambda m: gate(cummax_te, m) >= q_s,
                             window_iters)
    k = torch.clamp(cut - lo2, min=0)
    return torch.where(ok, seg_lo + lo2, zero), torch.where(ok, k, zero)


def windows_offsets_plain(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e,
                          window_iters: int):
    """Plain twin of K-B: (win_lo int32 [B], k int32 [B], offs int64 [B + 1]),
    offs the exclusive cumsum of k."""
    win_lo, k = stab_windows_plain(tgt_offsets, t_start, cummax_te, q_tid,
                                   q_s, q_e, window_iters)
    offs = torch.zeros(k.shape[0] + 1, dtype=torch.int64, device=k.device)
    offs[1:] = torch.cumsum(k, 0)
    return win_lo, k, offs


def _check_window_index(tgt_offsets, t_start, cummax_te) -> None:
    _check_i32("tgt_offsets", tgt_offsets)
    _check_i32("t_start", t_start)
    _check_i32("cummax_te", cummax_te, t_start.shape[0])


def windows_offsets(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e,
                    window_iters: int):
    """(win_lo int32 [B], k int32 [B], offs int64 [B + 1]): each query's
    candidate window and the exclusive int64 cumsum of the window sizes.
    K-B on CUDA tensors, one launch through a `DepthFront` of its own; the
    plain twin on CPU."""
    b = q_tid.shape[0]
    for name, t in (("q_tid", q_tid), ("q_s", q_s), ("q_e", q_e)):
        _check_i32(name, t, b)
    dev = _device_of(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e)
    front = DepthFront(SimpleNamespace(
        tgt_offsets=tgt_offsets, t_start=t_start, cummax_te=cummax_te,
        window_iters=window_iters, device=dev))
    return front.device_windows(q_tid, q_s, q_e)


def stab_windows(tgt_offsets, t_start, cummax_te, q_tid, q_s, q_e,
                 window_iters: int):
    """(win_lo, k) int32 [B]: the windows of `windows_offsets` (K-B on CUDA
    tensors, the plain twin on CPU)."""
    win_lo, k, _ = windows_offsets(tgt_offsets, t_start, cummax_te, q_tid,
                                   q_s, q_e, window_iters)
    return win_lo, k


# ── K-C: lanes + hit gate + projection ──────────────────────────────────


def _with_stats(dindex: TorchDeviceIndex, mask: int) -> bool:
    if "runs" not in dindex.arena:
        raise ValueError("exact projection requested before upload_arena")
    if not mask & _STATS_MASK:
        return False
    if "cum_match" not in dindex.arena:
        raise ValueError("identity-stats fields requested before upload_stats")
    return True


def _lane_records(lane_off, win_lo, lane_base: int, n_lanes: int):
    """(query, record) int64 [L] of each exact lane: the lane enumeration of
    csrc/lanes.cuh, query-major then ascending record."""
    dev = win_lo.device
    q = torch.repeat_interleave(
        torch.arange(win_lo.shape[0], device=dev), lane_off[1:] - lane_off[:-1],
        output_size=n_lanes,
    )
    lanes = torch.arange(n_lanes, device=dev, dtype=torch.int64) + lane_base
    return q, win_lo[q].long() + (lanes - lane_off[q])


def _stack_rows(values: dict, mask: int, n_lanes: int, dev) -> torch.Tensor:
    """The requested fields' int32 rows [n_rows, L] in RESULT_FIELDS order."""
    names = mask_fields(mask)
    if not names:
        return torch.empty((0, n_lanes), dtype=torch.int32, device=dev)
    return torch.stack([values[f].to(torch.int32) for f in names])


def _check_lanes(lane_off, win_lo, q_s, q_e, n_lanes: int, name: str):
    nq = win_lo.shape[0]
    _check_i32("lane_off", lane_off, nq + 1, torch.int64)
    _check_i32("win_lo", win_lo, nq)
    _check_i32("q_s", q_s, nq)
    _check_i32("q_e", q_e, nq)
    if not 0 <= n_lanes <= _MAX_LANES:
        raise ValueError(f"{name}: {n_lanes} lanes exceed int32")


def project_lanes_plain(dindex: TorchDeviceIndex, lane_off, win_lo, q_s, q_e,
                        *, q_base: int, lane_base: int, n_lanes: int,
                        clip_overlap: bool, mask: int):
    """Plain twin of K-C: (valid uint8 [L], rows int32 [n_rows, L]).  Unlike
    the kernel it fills every lane's rows; only valid lanes are meaningful."""
    dev = win_lo.device
    q, rec = _lane_records(lane_off, win_lo, lane_base, n_lanes)
    r_ts = dindex.t_start[rec]
    r_te = dindex.t_end[rec]
    rng_s = q_s[q]
    rng_e = q_e[q]
    hit = r_te >= rng_s
    if clip_overlap:
        # Transitive walkers project the clipped overlap (impg.rs:2395-2400).
        rng_s = torch.maximum(rng_s, r_ts)
        rng_e = torch.minimum(rng_e, r_te)
    with_stats = _with_stats(dindex, mask)
    keys = dindex.PROJECTION_CORE + (dindex.STATS_KEYS if with_stats else ())
    res = projection.project_batch(
        **{k: dindex.arena[k] for k in keys},
        op_off=dindex.op_off[rec],
        op_cnt=dindex.op_cnt[rec],
        t_start=r_ts,
        t_end=r_te,
        strand=dindex.strand[rec],
        range_start=rng_s,
        range_end=rng_e,
        search_iters=dindex.search_iters,
        with_stats=with_stats,
    )
    valid = res.valid & hit & (rng_s < rng_e)
    values = dict(
        res._asdict(),
        pair_rec=rec.to(torch.int32),
        pair_q=(q + q_base).to(torch.int32),
        query_id=dindex.query_id[rec],
    )
    return valid.to(torch.uint8), _stack_rows(values, mask, n_lanes, dev)


def project_lanes(dindex: TorchDeviceIndex, lane_off, win_lo, q_s, q_e, *,
                  q_base: int, lane_base: int, n_lanes: int,
                  clip_overlap: bool, mask: int):
    """Project lanes [lane_base, lane_base + n_lanes) of the queries whose
    int64 lane offsets are `lane_off` ([nq + 1], absolute; the caller
    guarantees lane_off[0] == lane_base and lane_off[nq] == lane_base +
    n_lanes, which the kernel trusts).  Returns (valid uint8 [L], rows int32 [n_rows, L]) with rows
    in RESULT_FIELDS order of `mask`.  K-C on CUDA, the plain twin on CPU."""
    nq = win_lo.shape[0]
    _check_lanes(lane_off, win_lo, q_s, q_e, n_lanes, "project_lanes")
    dev = _device_of(lane_off, win_lo, q_s, q_e, dindex.t_start)
    if dev.type == "cpu":
        return project_lanes_plain(
            dindex, lane_off, win_lo, q_s, q_e, q_base=q_base,
            lane_base=lane_base, n_lanes=n_lanes, clip_overlap=clip_overlap,
            mask=mask,
        )
    with_stats = _with_stats(dindex, mask)
    valid = torch.empty(n_lanes, dtype=torch.uint8, device=dev)
    rows = torch.empty((len(mask_fields(mask)), n_lanes), dtype=torch.int32,
                       device=dev)
    a = dindex.arena
    kernels.launch(
        "project_lanes", "impg_project_lanes",
        lane_off.data_ptr(), nq, lane_base, n_lanes, win_lo.data_ptr(),
        q_s.data_ptr(), q_e.data_ptr(), q_base,
        dindex.t_start.data_ptr(), dindex.t_end.data_ptr(),
        dindex.strand.data_ptr(), dindex.query_id.data_ptr(),
        dindex.op_off.data_ptr(), dindex.op_cnt.data_ptr(),
        a["cum_t"].data_ptr(), _columns_base(a, dindex.RUN_KEYS),
        _columns_base(a, dindex.STATS_KEYS) if with_stats else None,
        a["runs"].shape[0], int(clip_overlap), int(with_stats), mask,
        valid.data_ptr(), rows.data_ptr(), kernels.stream_of(valid),
    )
    return valid, rows


# ── K-E: lanes + hit gate + approximate (tracepoint) projection ─────────

# Fields approximate mode does not compute: K-E and its twin write zeros
# (impg_tpu/query/device.py:_lanes_core's tracepoint branch).
_APPROX_ZERO_FIELDS = (
    "first_run", "last_run", "first_clip", "last_rem", "i_count", "d_count",
    "i_bp", "d_bp",
)


def _require_tp(dindex: TorchDeviceIndex) -> None:
    if dindex.tp is None:
        raise ValueError("approximate projection needs an index uploaded "
                         "with_tracepoints")


def project_approx_lanes_plain(dindex: TorchDeviceIndex, lane_off, win_lo,
                               q_s, q_e, *, q_base: int, lane_base: int,
                               n_lanes: int, clip_overlap: bool, mask: int):
    """Plain twin of K-E: (valid uint8 [L], rows int32 [n_rows, L]), every
    lane's rows filled; only valid lanes are meaningful."""
    _require_tp(dindex)
    dev = win_lo.device
    q, rec = _lane_records(lane_off, win_lo, lane_base, n_lanes)
    r_ts = dindex.t_start[rec]
    r_te = dindex.t_end[rec]
    rng_s = q_s[q]
    rng_e = q_e[q]
    hit = r_te >= rng_s
    if clip_overlap:
        rng_s = torch.maximum(rng_s, r_ts)
        rng_e = torch.minimum(rng_e, r_te)
    res = approx.project_approx(dindex.tp, dindex.tp_spacing, rec, r_ts, r_te,
                                rng_s, rng_e)
    zero = torch.zeros_like(r_ts)
    values = dict(
        res,
        **dict.fromkeys(_APPROX_ZERO_FIELDS, zero),
        pair_rec=rec,
        pair_q=q + q_base,
        query_id=dindex.query_id[rec],
    )
    valid = res["valid"] & hit
    return valid.to(torch.uint8), _stack_rows(values, mask, n_lanes, dev)


def project_approx_lanes(dindex: TorchDeviceIndex, lane_off, win_lo, q_s,
                         q_e, *, q_base: int, lane_base: int, n_lanes: int,
                         clip_overlap: bool, mask: int):
    """`project_lanes` with the approximate (tracepoint) projection: K-E on
    CUDA, the plain twin on CPU."""
    _require_tp(dindex)
    nq = win_lo.shape[0]
    _check_lanes(lane_off, win_lo, q_s, q_e, n_lanes, "project_approx_lanes")
    dev = _device_of(lane_off, win_lo, q_s, q_e, dindex.t_start)
    if dev.type == "cpu":
        return project_approx_lanes_plain(
            dindex, lane_off, win_lo, q_s, q_e, q_base=q_base,
            lane_base=lane_base, n_lanes=n_lanes, clip_overlap=clip_overlap,
            mask=mask,
        )
    valid = torch.empty(n_lanes, dtype=torch.uint8, device=dev)
    rows = torch.empty((len(mask_fields(mask)), n_lanes), dtype=torch.int32,
                       device=dev)
    rec4 = _columns_base(dindex.tp, dindex.TP_RECORD_KEYS)
    if rec4 % 16:
        raise ValueError("tracepoint record columns must be 16-byte aligned")
    kernels.launch(
        "project_approx", "impg_project_approx",
        lane_off.data_ptr(), nq, lane_base, n_lanes, win_lo.data_ptr(),
        q_s.data_ptr(), q_e.data_ptr(), q_base,
        dindex.t_start.data_ptr(), dindex.t_end.data_ptr(),
        dindex.query_id.data_ptr(), rec4,
        _columns_base(dindex.tp, dindex.TP_BOUND_KEYS), dindex.tp_spacing,
        int(clip_overlap), mask, valid.data_ptr(), rows.data_ptr(),
        kernels.stream_of(valid),
    )
    return valid, rows


# ── K-D: order-preserving compaction ────────────────────────────────────


def compact_plain(valid, rows):
    """Plain twin of K-D: the valid lanes' columns of `rows`, in lane order."""
    return rows.index_select(1, torch.nonzero(valid, as_tuple=True)[0])


def _check_compact(valid, rows) -> torch.device:
    n_lanes = valid.shape[0]
    if (valid.dtype != torch.uint8 or valid.dim() != 1
            or not valid.is_contiguous()):
        raise ValueError("valid: expected a contiguous 1-D uint8 tensor")
    if (rows.dtype != torch.int32 or rows.dim() != 2
            or rows.shape[1] != n_lanes or not rows.is_contiguous()):
        raise ValueError("rows: expected a contiguous int32 [n_rows, n_lanes]")
    if n_lanes > _MAX_LANES:
        raise ValueError(f"compact: {n_lanes} lanes exceed int32")
    return _device_of(valid, rows)


def compact_launch(valid, rows):
    """Launch K-D on CUDA tensors and return at once: (out, scratch), where
    out is int32 [n_rows, n_lanes] and the hits are its first
    int(scratch[-1]) columns.  Per tile the scratch holds a 64-bit status
    word, then the tile counter and n_hits; the entry point zeroes it."""
    if _check_compact(valid, rows).type != "cuda":
        raise ValueError("compact_launch: expected CUDA tensors")
    n_lanes = valid.shape[0]
    out = torch.empty((rows.shape[0], n_lanes), dtype=torch.int32,
                      device=valid.device)
    scratch = torch.empty(-(-n_lanes // _COMPACT_TILE) + 2,
                          dtype=torch.int64, device=valid.device)
    kernels.launch(
        "compact", "impg_compact", valid.data_ptr(), n_lanes,
        rows.data_ptr(), rows.shape[0], out.data_ptr(), scratch.data_ptr(),
        kernels.stream_of(valid),
    )
    return out, scratch


def compact(valid, rows):
    """int32 [n_rows, n_hits]: K-D on CUDA tensors, the plain twin on CPU.

    On CUDA the result is a view of the first n_hits columns of an
    [n_rows, n_lanes] buffer (row stride n_lanes); the one host read is
    n_hits, after the kernel."""
    if _check_compact(valid, rows).type == "cpu":
        return compact_plain(valid, rows)
    if valid.shape[0] == 0:
        return rows[:, :0]
    out, scratch = compact_launch(valid, rows)
    return out[:, :int(scratch[-1])]


# ── engine ──────────────────────────────────────────────────────────────


def stab_layout(index, dindex: TorchDeviceIndex) -> tuple[StabLayout, float]:
    """(K-A's layout over `dindex`'s resident record columns, host seconds
    of its build).  The records are sorted by (target, t_start) and cut by
    tgt_offsets already, and cummax_te is resident; the build is the t_end
    column sorted within each segment (numpy, from `index`'s host copy) and
    its upload: index preparation, as cummax_te's is."""
    t0 = time.perf_counter()
    r = index.records
    layout = engine_layout(r.t_start, r.t_end, index.tgt_offsets,
                           dindex.tgt_offsets, dindex.t_start, dindex.t_end,
                           dindex.cummax_te)
    return layout, time.perf_counter() - t0


def lane_offsets(k: torch.Tensor):
    """The int64 exclusive cumsum of window sizes `k` ([B] -> [B + 1]), on
    k's device and as a host copy."""
    offs = torch.zeros(k.shape[0] + 1, dtype=torch.int64, device=k.device)
    offs[1:] = torch.cumsum(k, 0)
    return offs, offs.cpu().numpy()


def lane_chunks(offs: np.ndarray, lane_budget: int):
    """Query ranges [q0, q1) of at most `lane_budget` lanes each (a lone
    query with more lanes is a chunk of its own); empty ones skipped."""
    n = offs.size - 1
    q0 = 0
    while q0 < n:
        cut = np.searchsorted(offs, offs[q0] + lane_budget, "right")
        q1 = min(max(int(cut) - 1, q0 + 1), n)
        if offs[q1] > offs[q0]:
            yield q0, q1
        q0 = q1


def hits_to_numpy(hits: torch.Tensor, mask: int, fields) -> dict:
    """Compacted rows [n_rows, n_hits] (rows in RESULT_FIELDS order of
    `mask`) -> {field: int32 numpy} for `fields`, with `valid` all True
    and the scalar `n_hits`."""
    h = hits.cpu().numpy()
    names = mask_fields(mask)
    out = {f: h[names.index(f)] for f in fields if f != "valid"}
    out["valid"] = np.ones(h.shape[1], bool)
    out["n_hits"] = np.int32(h.shape[1])
    return out


class DepthFront:
    """One engine's round trip through K-B for a depth's queries.

    The three query columns are staged in pinned memory; one call of K-B's
    entry point copies them up into the rows of an int32 [3, capacity]
    buffer (each column contiguous for K-C), launches, copies the lane
    offsets (and, when asked, the window starts) back into pinned memory
    and waits for them.  The index columns are checked once, here.  The
    buffers and K-B's scratch grow and are reused, and their pointers are
    taken when they grow, so a call does no tensor operation.  What a call
    returns holds until the next call, which bumps `generation`: an engine
    serves one query stream at a time, and a stream checks the generation
    it started with before each chunk.  On a CPU index the plain twin
    runs."""

    def __init__(self, dindex: TorchDeviceIndex):
        _check_window_index(dindex.tgt_offsets, dindex.t_start,
                            dindex.cummax_te)
        self.dindex = dindex
        self.device = dindex.device
        self.cap = 0
        self.generation = 0
        self._pinned = None

    def _reserve(self, b: int) -> None:
        """Device buffers and K-B's scratch (a ticket, a done counter and
        one status word a block, zeroed once: each launch leaves it zeroed)
        for a batch of b queries, capacity doubled on growth."""
        if self.cap and b <= self.cap:
            return
        cap = max(2 * b, 4096)
        dev, d = self.device, self.dindex
        self._q = torch.empty((3, cap), dtype=torch.int32, device=dev)
        wk = torch.empty((2, cap), dtype=torch.int32, device=dev)
        self._win_lo, self._k = wk[0], wk[1]
        self._offs = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
        scratch = torch.zeros(-(-cap // _WINDOWS_THREADS) + 2,
                              dtype=torch.int64, device=dev)
        self._index_args = (
            d.tgt_offsets.data_ptr(), d.tgt_offsets.shape[0] - 1,
            d.t_start.data_ptr(), d.cummax_te.data_ptr())
        self._q_ptrs = tuple(row.data_ptr() for row in self._q)
        self._out_args = (
            self._win_lo.data_ptr(), self._k.data_ptr(),
            self._offs.data_ptr(), scratch.data_ptr(), scratch.shape[0])
        self._scratch = scratch
        self._pinned = None
        self.cap = cap

    def _stage(self) -> None:
        """Pinned staging at the front's capacity, made on first need."""
        if self._pinned is not None:
            return
        up = torch.empty(3 * self.cap, dtype=torch.int32, pin_memory=True)
        lo_h = torch.empty(self.cap, dtype=torch.int32, pin_memory=True)
        offs_h = torch.empty(self.cap + 1, dtype=torch.int64,
                             pin_memory=True)
        self._pinned = (up, lo_h, offs_h)
        self._up_np, self._lo_np, self._offs_np = (
            t.numpy() for t in self._pinned)
        self._offs_np[0] = 0
        self._lo_ptr = lo_h.data_ptr()
        self._host_args = (up.data_ptr(), offs_h.data_ptr())

    def _launch(self, b: int, q_ptrs, host_args) -> None:
        """K-B's one launch over b > 0 queries whose columns start at
        `q_ptrs`, into the front's buffers; `host_args` (staging, offs_h,
        lo_h or None) make it the round trip, three Nones a launch alone."""
        kernels.launch(
            "windows", "impg_windows_offsets", *self._index_args, *q_ptrs,
            b, *self._out_args, *host_args, kernels.stream_of(self._offs))

    def device_windows(self, q_tid, q_s, q_e):
        """(win_lo, k, offs) of B queries given as int32 tensors on the
        front's device: on CUDA one launch into the first B columns of the
        front's buffers (views; no copy, no wait), on CPU the plain
        twin."""
        if self.device.type == "cpu":
            d = self.dindex
            return windows_offsets_plain(d.tgt_offsets, d.t_start,
                                         d.cummax_te, q_tid, q_s, q_e,
                                         d.window_iters)
        b = q_tid.shape[0]
        self._reserve(b)
        if b:
            self._launch(b, (q_tid.data_ptr(), q_s.data_ptr(),
                             q_e.data_ptr()), (None, None, None))
        return self._win_lo[:b], self._k[:b], self._offs[:b + 1]

    def windows(self, q_tid, q_s, q_e, host_windows: bool = False):
        """(q int32 [3, *], win_lo, k, offs, offs_h, lo_h): the queries'
        rows and `windows_offsets` of them in the first B columns (offs:
        B + 1) of the front's device buffers; offs_h the host copy of offs
        [B + 1] and lo_h that of win_lo [B] when `host_windows` (else
        None)."""
        cols = [as_i32(np.asarray(a)) for a in (q_tid, q_s, q_e)]
        b = cols[0].size
        self.generation += 1
        if self.device.type == "cpu":
            q = torch.from_numpy(np.stack(cols))
            win_lo, k, offs = self.device_windows(q[0], q[1], q[2])
            return (q, win_lo, k, offs, offs.numpy(),
                    win_lo.numpy() if host_windows else None)
        self._reserve(b)
        self._stage()
        self._up_np[:3 * b].reshape(3, b)[:] = cols
        if b:
            self._launch(b, self._q_ptrs, (
                *self._host_args, self._lo_ptr if host_windows else None))
        return (self._q, self._win_lo, self._k, self._offs,
                self._offs_np[:b + 1],
                self._lo_np[:b] if host_windows else None)

    def check(self, generation: int) -> None:
        """Raise unless the front still holds the call of `generation`."""
        if generation != self.generation:
            raise RuntimeError(
                "another query stream reused this engine's K-B buffers "
                "before this stream was drained; an engine serves one "
                "stream at a time")


class TorchDeviceEngine:
    """Host-facing engine with DeviceEngine's contract: numpy in, numpy out.

    Built `with_tracepoints`, it also serves approximate (tracepoint) walks
    (`supports_approximate`) and uploads the CIGAR arena only on its first
    exact stream; without, query/engine.py routes approximate walks to the
    host engine.  It serves one query stream at a time: a stream's chunks
    read the buffers of the engine's `DepthFront`, which the next stream
    reuses; a stream whose buffers were reused raises."""

    def __init__(self, index, device, with_tracepoints: bool = False):
        self.device = check_device(device)
        self.index = index
        self.dindex = TorchDeviceIndex.build(index, self.device,
                                             with_tracepoints)
        self.lane_budget = LANE_BUDGET
        self.front = DepthFront(self.dindex)
        self._stab_layout = None
        self.stab_layout_s = 0.0  # host seconds of the K-A layout build

    @property
    def supports_approximate(self) -> bool:
        return self.dindex.tp is not None

    def _ensure_arena(self) -> None:
        """Upload the lean arena on first need (a tracepoint engine's
        approximate walks never touch it)."""
        if "runs" not in self.dindex.arena:
            self.dindex.upload_arena(
                self.index.arena.projection_kwargs(with_stats=False)
            )

    def _ensure_stats(self) -> None:
        """Upload the identity-stats arena arrays on first need (the lean BFS
        path never touches them)."""
        if "cum_match" not in self.dindex.arena:
            self.dindex.upload_stats(self.index.arena.projection_kwargs())

    def _upload_queries(self, q_tid, q_s, q_e):
        return tuple(upload_i32(np.asarray(a), self.device)
                     for a in (q_tid, q_s, q_e))

    def query_batch_stream(self, q_tid, q_s, q_e, clip_overlap: bool = False,
                           approximate: bool = False, fields=None):
        """Yield one dict per lane chunk: each requested field as int32 numpy
        (hits only, query-major then ascending record), `valid` all True,
        and the scalars `k_needed` (largest window in the chunk) and
        `n_hits`.  `pair_q` indexes the query within the batch.
        `approximate` projects through the tracepoints (K-E) and never
        uploads the CIGAR arena."""
        if approximate and not self.supports_approximate:
            raise ValueError(
                "approximate walks need TorchDeviceEngine(..., "
                "with_tracepoints=True); supports_approximate is False"
            )
        fields = RESULT_FIELDS if fields is None else tuple(fields)
        mask = field_mask(fields)
        if not approximate:
            self._ensure_arena()
            if mask & _STATS_MASK:
                self._ensure_stats()
        project = project_approx_lanes if approximate else project_lanes
        d = self.dindex
        front = self.front
        q, win_lo, _, offs, offs_h, _ = front.windows(q_tid, q_s, q_e)
        generation = front.generation
        for q0, q1 in lane_chunks(offs_h, self.lane_budget):
            front.check(generation)
            valid, rows = project(
                d, offs[q0:q1 + 1], win_lo[q0:q1], q[1, q0:q1], q[2, q0:q1],
                q_base=q0, lane_base=int(offs_h[q0]),
                n_lanes=int(offs_h[q1] - offs_h[q0]),
                clip_overlap=clip_overlap, mask=mask,
            )
            out = hits_to_numpy(compact(valid, rows), mask, fields)
            out["k_needed"] = np.int32(np.diff(offs_h[q0:q1 + 1]).max())
            yield out

    def query_batch(self, q_tid, q_s, q_e, clip_overlap: bool = False,
                    approximate: bool = False) -> dict:
        """One batch, every RESULT_FIELD; see `query_batches`."""
        return self.query_batches([(q_tid, q_s, q_e)], clip_overlap,
                                  approximate)[0]

    def query_batches(self, batches: list, clip_overlap: bool = False,
                      approximate: bool = False) -> list[dict]:
        """Each batch's stream concatenated into one dict."""
        results = []
        for q_tid, q_s, q_e in batches:
            parts = list(self.query_batch_stream(
                q_tid, q_s, q_e, clip_overlap, approximate
            ))
            merged = {
                f: (np.concatenate([p[f] for p in parts]) if parts
                    else np.zeros(0, bool if f == "valid" else np.int32))
                for f in RESULT_FIELDS
            }
            merged["k_needed"] = np.int32(
                max((int(p["k_needed"]) for p in parts), default=0)
            )
            merged["n_hits"] = np.int32(sum(int(p["n_hits"]) for p in parts))
            results.append(merged)
        return results

    def stab_layout(self) -> StabLayout:
        """K-A's segmented layout over the uploaded record columns, built on
        first use (`stab_layout`) and kept."""
        if self._stab_layout is None:
            self._stab_layout, self.stab_layout_s = stab_layout(self.index,
                                                                self.dindex)
        return self._stab_layout

    def stab_counts(self, q_tid, q_s, q_e) -> np.ndarray:
        """Per-region overlapping directed-record counts (closed-interval
        stab) through K-A, over the uploaded record columns — the primitive
        behind `stats -r/-b`."""
        qt, qs, qe = self._upload_queries(q_tid, q_s, q_e)
        return stab_counts_segmented(self.stab_layout(), qt, qs,
                                     qe).cpu().numpy()
