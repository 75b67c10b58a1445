"""Per-query interval-stab counts: the K-A kernel's wrapper and plain twins.

Counterpart of impg_tpu/ops/pallas_stab.py.  For each query (tid, s, e) the
count of records with rec_tid == tid, rec_ts <= e and rec_te >= s
(closed-interval stab, coitrees semantics); it backs `stats -r/-b` region
depth.

The Pallas kernel tests every record against every query.  The CUDA kernel
(csrc/stab_count.cu) counts inside the query's target segment instead, by
two searches a query, over the records in a segmented layout
(`StabLayout`): sorted by (target, t_start) and cut into target segments,
with the prefix max of t_end and the t_end values sorted within each
segment beside them.  The engines hold that layout over their resident
record columns (`engine_layout`); `stab_counts` builds it for arbitrary
records (`segmented_layout`).

Two plain versions: `stab_counts_plain` keeps the Pallas kernel's layout,
1024-record tiles padded with non-matching sentinels (`pad_records`),
counted by brute force, because that is the function; it is the kernel's
yardstick and the CPU path of `stab_counts`.  `stab_counts_segmented_plain`
is the segmented count in torch (`torch.searchsorted` and the window
count), the CPU path of `stab_counts_segmented`, so that the CPU tests hold
the kernel's algorithm against JAX as well.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from impg_tpu_torch import kernels
from impg_tpu_torch.ops.xfer import upload_i32

TILE = 1024
_I32_MIN = -(2**31)


def pad_records(rec_tid, rec_ts, rec_te):
    """Pad to a TILE multiple (at least one tile) with tid = -1, ts = INT_MAX,
    te = INT_MIN, as impg_tpu/ops/pallas_stab.py:pad_records does."""
    n = rec_tid.shape[0]
    n_pad = max(TILE, -(-n // TILE) * TILE)

    def padded(a, fill):
        out = torch.full((n_pad,), fill, dtype=torch.int32, device=a.device)
        out[:n] = a
        return out

    return (
        padded(rec_tid, -1),
        padded(rec_ts, 2**31 - 1),
        padded(rec_te, -(2**31)),
    )


def stab_counts_plain(rec_tid, rec_ts, rec_te, q_tid, q_s, q_e):
    """Plain torch twin: the sentinel-padded tiles, counted tile by tile."""
    tid, ts, te = pad_records(rec_tid, rec_ts, rec_te)
    out = torch.zeros(q_tid.shape[0], dtype=torch.int32, device=q_tid.device)
    for lo in range(0, tid.shape[0], TILE):
        hit = (
            (tid[lo:lo + TILE, None] == q_tid[None, :])
            & (ts[lo:lo + TILE, None] <= q_e[None, :])
            & (te[lo:lo + TILE, None] >= q_s[None, :])
        )
        out += hit.sum(dim=0, dtype=torch.int32)
    return out


# ── the segmented layout ────────────────────────────────────────────────


def compute_cummax_te(t_end: np.ndarray, tgt_offsets: np.ndarray) -> np.ndarray:
    """Prefix max of t_end within each target segment (host, numpy).

    One running max over keys (segment << 32) + t_end: a later segment's keys
    all exceed an earlier one's, so the max restarts at every segment."""
    out = np.zeros(t_end.size, np.int32)
    offs = np.asarray(tgt_offsets, np.int64)
    lo, hi = int(offs[0]), int(offs[-1])
    if hi <= lo:
        return out
    seg = np.repeat(np.arange(offs.size - 1, dtype=np.int64), np.diff(offs))
    key = (seg << 32) + t_end[lo:hi].astype(np.int64)
    np.maximum.accumulate(key, out=key)
    out[lo:hi] = (key - (seg << 32)).astype(np.int32)
    return out


def sorted_te(t_start: np.ndarray, t_end: np.ndarray,
              tgt_offsets: np.ndarray) -> tuple[np.ndarray, bool]:
    """(te_sorted int32 [N], wellformed) on the host: t_end sorted within
    each target segment, by one sort of the keys (segment << 32) +
    (t_end - INT_MIN), which leaves every segment in its place; and whether
    every record has t_start <= t_end (the two-search count's condition)."""
    t_end = np.asarray(t_end)
    out = np.zeros(t_end.size, np.int32)
    offs = np.asarray(tgt_offsets, np.int64)
    lo, hi = int(offs[0]), int(offs[-1])
    if hi > lo:
        seg = np.repeat(np.arange(offs.size - 1, dtype=np.int64),
                        np.diff(offs))
        key = (seg << 32) + (t_end[lo:hi].astype(np.int64) - _I32_MIN)
        key.sort()
        out[lo:hi] = ((key & 0xFFFFFFFF) + _I32_MIN).astype(np.int32)
    wellformed = bool(np.all(np.asarray(t_start) <= t_end))
    return out, wellformed


@dataclass
class StabLayout:
    """Records in the layout K-A counts over (int32 tensors on one device).

    Segment i holds records [tgt_offsets[i], tgt_offsets[i + 1]), ascending
    in t_start.  Segment i is target i, or, where `seg_tid` is given,
    target seg_tid[i] (ascending)."""

    tgt_offsets: torch.Tensor  # [n_seg + 1]
    seg_tid: torch.Tensor | None  # [n_seg], or None: segment i is target i
    t_start: torch.Tensor  # [N]
    t_end: torch.Tensor  # [N], in t_start's order
    cummax_te: torch.Tensor  # [N], prefix max of t_end within a segment
    te_sorted: torch.Tensor  # [N], t_end ascending within a segment
    wellformed: bool  # every record has t_start <= t_end

    @property
    def n_seg(self) -> int:
        return self.tgt_offsets.shape[0] - 1


def engine_layout(t_start_h, t_end_h, tgt_offsets_h, tgt_offsets, t_start,
                  t_end, cummax_te) -> StabLayout:
    """The layout over an index's resident record columns (device tensors,
    records sorted by (target, t_start), segment i = target i): only the
    sorted t_end column is new, built from the host copies (`sorted_te`)
    and uploaded."""
    te, wellformed = sorted_te(t_start_h, t_end_h, tgt_offsets_h)
    return StabLayout(tgt_offsets, None, t_start, t_end, cummax_te,
                      upload_i32(te, t_start.device), wellformed)


def segmented_layout(rec_tid, rec_ts, rec_te) -> StabLayout:
    """The layout of arbitrary records (int32 tensors, any order and any
    target ids), built on the host and uploaded to their device: records
    sorted by (tid, ts), one segment per distinct target id."""
    tid = rec_tid.cpu().numpy()
    ts = rec_ts.cpu().numpy()
    te = rec_te.cpu().numpy()
    order = np.lexsort((ts, tid))
    tid, ts, te = tid[order], ts[order], te[order]
    seg_tid, counts = np.unique(tid, return_counts=True)
    offs = np.zeros(seg_tid.size + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    te_sorted, wellformed = sorted_te(ts, te, offs)
    up = lambda a: upload_i32(a, rec_tid.device)  # noqa: E731
    return StabLayout(up(offs), up(seg_tid), up(ts), up(te),
                      up(compute_cummax_te(te, offs)), up(te_sorted),
                      wellformed)


def stab_counts_segmented_plain(layout: StabLayout, q_tid, q_s, q_e):
    """Plain torch version of K-A's segmented count: the same searches
    (`torch.searchsorted` over (segment << 32) + (value - INT_MIN) keys),
    the two-search count where it holds, the window count elsewhere."""
    dev = q_tid.device
    n_seg = layout.n_seg
    b = q_tid.shape[0]
    out = torch.zeros(b, dtype=torch.int32, device=dev)
    n_rec = layout.t_start.shape[0]
    if n_seg <= 0 or b == 0 or n_rec == 0:
        return out
    t = q_tid.long()
    if layout.seg_tid is None:
        seg = t
        ok = (t >= 0) & (t < n_seg)
    else:
        seg = torch.searchsorted(layout.seg_tid.long(), t)
        ok = seg < n_seg
        ok &= layout.seg_tid.long()[seg.clamp(max=n_seg - 1)] == t
    seg = torch.where(ok, seg, 0)
    offs = layout.tgt_offsets.long()
    rec_seg = torch.repeat_interleave(
        torch.arange(n_seg, device=dev), offs[1:] - offs[:-1],
        output_size=n_rec,
    )

    def keys(col):
        return (rec_seg << 32) + (col.long() - _I32_MIN)

    def first(col, x, right=False):
        """First record of the query's segment whose `col` passes x."""
        return torch.searchsorted(keys(col), (seg << 32) + (x.long() - _I32_MIN),
                                  right=right)

    s, e = q_s.long(), q_e.long()
    hi = first(layout.t_start, q_e, right=True)  # first ts > e
    two = (s <= e) & layout.wellformed
    lb = first(layout.te_sorted, q_s)  # first sorted te >= s
    lo = first(layout.cummax_te, q_s)  # first cummax_te >= s
    width = torch.where(ok & ~two, (hi - lo).clamp(min=0), 0)
    q_of = torch.repeat_interleave(torch.arange(b, device=dev), width)
    start = torch.cumsum(width, 0) - width
    pos = (torch.arange(q_of.shape[0], device=dev) - start[q_of]) + lo[q_of]
    hit = (layout.t_end.long()[pos] >= s[q_of]).long()
    window = torch.zeros(b, dtype=torch.int64, device=dev).index_add_(
        0, q_of, hit)
    cnt = torch.where(two, hi - lb, window)
    return torch.where(ok, cnt, 0).to(torch.int32)


# ── the wrappers ────────────────────────────────────────────────────────


def _check(name, t, n=None):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected length {n}, got {t.shape[0]}")


def _device(ts) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"stab_counts: tensors on several devices {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"stab_counts: unsupported device {dev}")
    return dev


def _check_queries(q_tid, q_s, q_e) -> int:
    b = q_tid.shape[0]
    for name, t in (("q_tid", q_tid), ("q_s", q_s), ("q_e", q_e)):
        _check(name, t, b)
    return b


def stab_counts_segmented(layout: StabLayout, q_tid, q_s, q_e):
    """int32 [B] counts over a segmented layout: K-A on CUDA tensors (or it
    raises), `stab_counts_segmented_plain` on CPU tensors."""
    b = _check_queries(q_tid, q_s, q_e)
    n = layout.t_start.shape[0]
    _check("tgt_offsets", layout.tgt_offsets)
    for name in ("t_start", "t_end", "cummax_te", "te_sorted"):
        _check(name, getattr(layout, name), n)
    cols = [layout.tgt_offsets, layout.t_start, layout.t_end,
            layout.cummax_te, layout.te_sorted, q_tid, q_s, q_e]
    if layout.seg_tid is not None:
        _check("seg_tid", layout.seg_tid, layout.n_seg)
        cols.append(layout.seg_tid)
    if _device(cols).type == "cpu":
        return stab_counts_segmented_plain(layout, q_tid, q_s, q_e)
    out = torch.empty(b, dtype=torch.int32, device=q_tid.device)
    seg_tid = layout.seg_tid
    kernels.launch(
        "stab_count", "impg_stab_count",
        layout.tgt_offsets.data_ptr(),
        None if seg_tid is None or seg_tid.numel() == 0 else seg_tid.data_ptr(),
        layout.n_seg, layout.t_start.data_ptr(), layout.t_end.data_ptr(),
        layout.cummax_te.data_ptr(), layout.te_sorted.data_ptr(),
        int(layout.wellformed), q_tid.data_ptr(), q_s.data_ptr(),
        q_e.data_ptr(), b, out.data_ptr(), kernels.stream_of(out),
    )
    return out


def stab_counts(rec_tid, rec_ts, rec_te, q_tid, q_s, q_e):
    """int32 [B] counts over arbitrary records.  CPU tensors take the plain
    twin; CUDA tensors build the segmented layout (`segmented_layout`, a
    host pass) and launch K-A (or raise).  Callers that count often over
    the same records keep a layout and call `stab_counts_segmented`."""
    n = rec_tid.shape[0]
    b = _check_queries(q_tid, q_s, q_e)
    for name, t in (("rec_tid", rec_tid), ("rec_ts", rec_ts),
                    ("rec_te", rec_te)):
        _check(name, t, n)
    if _device((rec_tid, rec_ts, rec_te, q_tid, q_s, q_e)).type == "cpu":
        return stab_counts_plain(rec_tid, rec_ts, rec_te, q_tid, q_s, q_e)
    if b == 0:
        return torch.zeros(0, dtype=torch.int32, device=q_tid.device)
    return stab_counts_segmented(segmented_layout(rec_tid, rec_ts, rec_te),
                                 q_tid, q_s, q_e)
