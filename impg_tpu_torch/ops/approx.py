"""Approximate (tracepoint) projection through directed records, in torch.

Plain-torch counterpart of impg_tpu/query/device.py:_project_approx_device:
the same int32 arithmetic on the same tracepoint columns (see
impg_tpu/index/tracepoints.py for what they hold).  On the device path the
same arithmetic runs fused inside the K-E kernel (csrc/project_approx.cu);
this version is that kernel's plain twin and the CPU path.

JAX's `//` on int32 is a floor division, so every division here is
`torch.div(..., rounding_mode="floor")`, and `jnp.clip(x, lo, hi)` is
`minimum(maximum(x, lo), hi)` (which yields `hi` when lo > hi).  The query
offset inside a segment, od * q_delta / t, is rounded half to even in exact
integers: |q_delta| splits as (|q_delta| // t) * t + rem, so every product
stays below 2^31 (od, rem <= t <= spacing) and the result is bit-equal to
the host's float64 np.round.
"""

from __future__ import annotations

import torch


def _floordiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def project_approx(tp: dict, spacing: int, rec, r_ts, r_te, rng_s, rng_e
                   ) -> dict:
    """Approximate projection of [rng_s, rng_e) through records `rec`.

    `tp` holds the int32 tracepoint columns of TorchDeviceIndex.TP_KEYS;
    `rec` indexes records, the other arguments are int32 per lane.  Returns
    int32 `pq_start`, `pq_end`, `pt_start`, `pt_end`, `matches`,
    `mismatches` and a bool `valid` (the range overlaps the record)."""
    rec = rec.long()
    off = tp["seg_off"][rec]
    nseg = tp["n_seg"][rec]
    q0 = tp["q_start"][rec]
    qe = tp["q_end"][rec]
    qb = tp["q_bound"]
    zero = torch.zeros_like(nseg)
    valid = (rng_s < r_te) & (rng_e > r_ts) & (rng_s < rng_e)
    rs_c = _clip(rng_s, r_ts, r_te - 1)
    re_c = _clip(rng_e, r_ts + 1, r_te)
    i0 = _clip(_floordiv(rs_c - r_ts, spacing), zero, nseg - 1)
    j1 = _clip(_floordiv(re_c - 1 - r_ts, spacing), zero, nseg - 1)

    def take(a, idx):
        return a[idx.long()]

    def boundary(i):
        return torch.minimum(r_ts + i * spacing, r_te)

    def refine(i, overlap_pos):
        seg_s = boundary(i)
        seg_e = boundary(i + 1)
        q_pos = take(qb, off + i)
        q_delta = take(qb, off + i + 1) - q_pos
        t_delta = seg_e - seg_s
        t = torch.clamp(t_delta, min=1)
        od = overlap_pos - seg_s  # in [0, t_delta]
        mag = q_delta.abs()
        sign = torch.where(q_delta < 0, -1, 1).to(torch.int32)
        whole = _floordiv(mag, t)
        rem = mag - whole * t
        p2 = rem * od
        q2 = _floordiv(p2, t)
        r2 = p2 - q2 * t
        floor_total = whole * od + q2
        half = 2 * r2
        add = (half > t) | ((half == t) & ((floor_total & 1) == 1))
        advance = sign * (floor_total + add.to(torch.int32))
        advance = torch.where(t_delta > 0, advance, zero)
        return _clip(q_pos + advance, torch.minimum(q0, qe),
                     torch.maximum(q0, qe))

    pq_start = refine(i0, torch.maximum(boundary(i0), rs_c))
    pq_end = refine(j1, torch.minimum(boundary(j1 + 1), re_c))
    aligned = (take(tp["pre_aligned"], off + j1 + 1)
               - take(tp["pre_aligned"], off + i0))
    diffs = take(tp["pre_diffs"], off + j1 + 1) - take(tp["pre_diffs"], off + i0)
    return dict(
        valid=valid,
        pq_start=pq_start,
        pq_end=pq_end,
        pt_start=rng_s,
        pt_end=rng_e,
        matches=torch.clamp(aligned - diffs, min=0),
        mismatches=diffs,
    )
