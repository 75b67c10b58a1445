"""Per-query interval-stab counts: the K-A kernel's wrapper and plain twin.

Counterpart of impg_tpu/ops/pallas_stab.py.  For each query (tid, s, e) the
count of records with rec_tid == tid, rec_ts <= e and rec_te >= s
(closed-interval stab, coitrees semantics); it backs `stats -r/-b` region
depth.  The CUDA kernel (csrc/stab_count.cu) takes the records unpadded; the
plain twin keeps the Pallas kernel's layout, 1024-record tiles padded with
non-matching sentinels (`pad_records`), so both give `stab_counts_host`'s
answer.
"""

from __future__ import annotations

import torch

from impg_tpu_torch import kernels

TILE = 1024
_MAX_QUERIES = 65535 * 256  # grid.y limit x threads per block


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


def _check(name, t, n=None):
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: expected length {n}, got {t.shape[0]}")


def stab_counts(rec_tid, rec_ts, rec_te, q_tid, q_s, q_e):
    """int32 [B] counts.  CPU tensors take the plain twin; CUDA tensors launch
    K-A (or raise)."""
    n, b = rec_tid.shape[0], q_tid.shape[0]
    for name, t, size in (
        ("rec_tid", rec_tid, n), ("rec_ts", rec_ts, n), ("rec_te", rec_te, n),
        ("q_tid", q_tid, b), ("q_s", q_s, b), ("q_e", q_e, b),
    ):
        _check(name, t, size)
    devices = {t.device for t in (rec_tid, rec_ts, rec_te, q_tid, q_s, q_e)}
    if len(devices) != 1:
        raise ValueError(f"stab_counts: tensors on several devices {devices}")
    if q_tid.device.type == "cpu":
        return stab_counts_plain(rec_tid, rec_ts, rec_te, q_tid, q_s, q_e)
    if q_tid.device.type != "cuda":
        raise ValueError(f"stab_counts: unsupported device {q_tid.device}")
    if b > _MAX_QUERIES:
        raise ValueError(f"stab_counts: at most {_MAX_QUERIES} queries a call")
    out = torch.empty(b, dtype=torch.int32, device=q_tid.device)
    kernels.launch(
        "stab_count", "impg_stab_count",
        rec_tid.data_ptr(), rec_ts.data_ptr(), rec_te.data_ptr(), n,
        q_tid.data_ptr(), q_s.data_ptr(), q_e.data_ptr(), b,
        out.data_ptr(), kernels.stream_of(out),
    )
    return out
