"""Result merging: query-axis merge, CIGAR-faithful 2D merge, gap-2D merge.

The port's copy of impg_tpu/query/merge.py
(tests/test_torch_host.py holds the two equal).

Exact-semantics reimplementations of the reference's output merge pipeline:
  - merge_query_adjusted_intervals (main.rs:12474): sort by (seq, start,
    strand) then sweep-merge on the query axis with `-d`, optionally across
    strands (larger span wins orientation).
  - merge_adjusted_intervals (main.rs:12563): CIGAR-faithful merge of
    contiguous / identically-overlapping / gap-within-d chains on BOTH axes,
    concatenating CIGAR runs (gap-filling with I/D runs).
  - merge_adjusted_intervals_gap_2d (main.rs:12858): union-find gap-tolerant
    merge for CIGAR-less rows (BED path, syng output).
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.query.engine import Row


def merge_consecutive_runs(runs: np.ndarray) -> np.ndarray:
    """Coalesce adjacent runs of the same op."""
    if runs.size <= 1:
        return runs
    ops = cigar.run_op(runs)
    lens = cigar.run_len(runs).astype(np.int64)
    boundary = np.concatenate([[True], ops[1:] != ops[:-1]])
    group = np.cumsum(boundary) - 1
    out_lens = np.zeros(int(group[-1]) + 1, np.int64)
    np.add.at(out_lens, group, lens)
    out_ops = ops[boundary].astype(np.uint32)
    return cigar.pack(out_lens, out_ops)


def _runs_to_list(runs: np.ndarray) -> list[tuple[int, int]]:
    return list(
        zip(cigar.run_len(runs).tolist(), cigar.run_op(runs).tolist())
    )


def _query_delta_abs(length: int, op: int) -> int:
    return 0 if op == cigar.OP_D else length


def _target_delta(length: int, op: int) -> int:
    return 0 if op == cigar.OP_I else length


def _extract_suffix(runs: np.ndarray, query_len: int) -> list[tuple[int, int]]:
    """Last runs covering `query_len` query bases (main.rs:13054)."""
    result = []
    remaining = query_len
    for length, op in reversed(_runs_to_list(runs)):
        if remaining <= 0:
            break
        qd = _query_delta_abs(length, op)
        if qd <= remaining:
            result.append((length, op))
            remaining -= qd
        elif qd > 0:
            scale = np.float32(remaining) / np.float32(qd)
            new_len = int(np.float32(length) * scale)
            result.append((new_len, op))
            remaining = 0
    result.reverse()
    return result


def _extract_prefix(runs: np.ndarray, query_len: int) -> list[tuple[int, int]]:
    result = []
    remaining = query_len
    for length, op in _runs_to_list(runs):
        if remaining <= 0:
            break
        qd = _query_delta_abs(length, op)
        if qd <= remaining:
            result.append((length, op))
            remaining -= qd
        elif qd > 0:
            scale = np.float32(remaining) / np.float32(qd)
            new_len = int(np.float32(length) * scale)
            result.append((new_len, op))
            remaining = 0
    return result


def _check_overlap_match(
    current: np.ndarray, nxt: np.ndarray, query_overlap_len: int
) -> bool:
    return _extract_suffix(current, query_overlap_len) == _extract_prefix(
        nxt, query_overlap_len
    )


def _trim_prefix(runs: np.ndarray, query_len: int, target_len: int) -> np.ndarray:
    """Drop the runs covering the first query_len/target_len bases
    (main.rs:13127)."""
    items = _runs_to_list(runs)
    result: list[tuple[int, int]] = []
    q_consumed = 0
    t_consumed = 0
    start_idx = len(items)
    for idx, (length, op) in enumerate(items):
        qd = _query_delta_abs(length, op)
        td = _target_delta(length, op)
        if q_consumed + qd > query_len or t_consumed + td > target_len:
            q_rem = query_len - q_consumed
            t_rem = target_len - t_consumed
            if qd > 0 and td > 0:
                skip_ratio = min(
                    np.float32(q_rem) / np.float32(qd),
                    np.float32(t_rem) / np.float32(td),
                )
            elif qd > 0:
                skip_ratio = np.float32(q_rem) / np.float32(qd)
            elif td > 0:
                skip_ratio = np.float32(t_rem) / np.float32(td)
            else:
                skip_ratio = np.float32(0.0)
            skip_len = int(np.float32(length) * skip_ratio)
            if skip_len < length:
                result.append((length - skip_len, op))
            start_idx = idx + 1
            break
        q_consumed += qd
        t_consumed += td
        if q_consumed >= query_len and t_consumed >= target_len:
            start_idx = idx + 1
            break
    result.extend(items[start_idx:])
    if not result:
        return np.zeros(0, np.uint32)
    lens, ops = zip(*result)
    return cigar.pack(np.asarray(lens, np.int64), np.asarray(ops, np.uint32))


def merge_query_adjusted_intervals(
    results: list[Row], merge_distance: int, merge_strands: bool
) -> list[Row]:
    if len(results) <= 1 or (merge_distance < 0 and not merge_strands):
        return results

    def sort_key(row: Row):
        is_forward = row.q_first <= row.q_last
        start = row.q_first if is_forward else row.q_last
        return (row.q_id, start, not is_forward)

    results.sort(key=sort_key)

    out = [results[0]]
    for nxt in results[1:]:
        curr = out[-1]
        curr_fwd = curr.q_first <= curr.q_last
        next_fwd = nxt.q_first <= nxt.q_last
        curr_s, curr_e = (
            (curr.q_first, curr.q_last) if curr_fwd else (curr.q_last, curr.q_first)
        )
        next_s, next_e = (
            (nxt.q_first, nxt.q_last) if next_fwd else (nxt.q_last, nxt.q_first)
        )
        if (
            merge_distance < 0
            or curr.q_id != nxt.q_id
            or (not merge_strands and curr_fwd != next_fwd)
            or next_s > curr_e + merge_distance
        ):
            out.append(nxt)
        else:
            merged_s = min(curr_s, next_s)
            merged_e = max(curr_e, next_e)
            if merge_strands and curr_fwd != next_fwd:
                merged_fwd = (
                    next_fwd if (next_e - next_s) > (curr_e - curr_s) else curr_fwd
                )
            else:
                merged_fwd = curr_fwd
            if merged_fwd:
                curr.q_first, curr.q_last = merged_s, merged_e
            else:
                curr.q_first, curr.q_last = merged_e, merged_s
    results[:] = out
    return results


def merge_adjusted_intervals(results: list[Row], merge_distance: int) -> list[Row]:
    if len(results) <= 1 or merge_distance < 0:
        return results

    def sort_key(row: Row):
        # PARITY NOTE: strict `<` here vs `<=` in the merge loop mirrors
        # the reference exactly (main.rs:12567 sort vs :12598 loop) — a
        # zero-length row sorts with the reverse partition but merges as
        # forward, as it does there.
        query_forward = row.q_first < row.q_last
        pos = row.q_first if query_forward else row.q_last
        return (row.q_id, query_forward, pos, row.t_id, row.t_first)

    results.sort(key=sort_key)
    merged: list[Row] = []
    curr = results[0]
    for nxt in results[1:]:
        q_fwd = curr.q_first <= curr.q_last
        n_fwd = nxt.q_first <= nxt.q_last
        if curr.t_first > curr.t_last or nxt.t_first > nxt.t_last:
            raise AssertionError("Target intervals should always be forward")
        if curr.q_id != nxt.q_id or curr.t_id != nxt.t_id or q_fwd != n_fwd:
            merged.append(curr)
            curr = nxt
            continue

        if q_fwd:
            q_contig = curr.q_last == nxt.q_first
            t_contig = curr.t_last == nxt.t_first
            q_overlap = curr.q_last > nxt.q_first
            t_overlap = curr.t_last > nxt.t_first
        else:
            q_contig = curr.q_first == nxt.q_last
            t_contig = curr.t_first == nxt.t_last
            q_overlap = curr.q_first > nxt.q_last
            t_overlap = curr.t_first < nxt.t_last

        if q_contig and t_contig:
            if q_fwd:
                curr.q_last = nxt.q_last
                curr.t_last = nxt.t_last
                curr.cigar = np.concatenate([curr.cigar, nxt.cigar])
            else:
                curr.q_first = nxt.q_first
                curr.t_first = nxt.t_first
                curr.cigar = np.concatenate([nxt.cigar, curr.cigar])
            curr.cigar = merge_consecutive_runs(curr.cigar)
            continue

        if q_overlap and t_overlap:
            # PARITY NOTE: the reference computes these the same way
            # (main.rs:12681-12692), which yields NEGATIVE values whenever
            # q_overlap/t_overlap hold — so its `> 0` gate (and ours) never
            # fires and the overlap-trim branch is unreachable.  Kept
            # verbatim: bit-identical output is the contract; "fixing" the
            # sign here would diverge from the reference.
            if q_fwd:
                q_ov = nxt.q_first - curr.q_last
                t_ov = nxt.t_first - curr.t_last
            else:
                q_ov = nxt.q_last - curr.q_first
                t_ov = curr.t_first - nxt.t_last
            if q_ov > 0 and t_ov > 0 and _check_overlap_match(
                curr.cigar, nxt.cigar, q_ov
            ):
                trimmed = _trim_prefix(nxt.cigar, q_ov, t_ov)
                if q_fwd:
                    curr.q_last = nxt.q_last
                    curr.t_last = nxt.t_last
                    curr.cigar = np.concatenate([curr.cigar, trimmed])
                else:
                    curr.q_first = nxt.q_first
                    curr.t_first = nxt.t_first
                    curr.cigar = np.concatenate([trimmed, curr.cigar])
                continue

        if not q_overlap and not t_overlap:
            if q_fwd:
                q_gap = nxt.q_first - curr.q_last
                t_gap = nxt.t_first - curr.t_last
            else:
                q_gap = curr.q_first - nxt.q_last
                t_gap = curr.t_first - nxt.t_last
            if (
                q_gap >= 0
                and t_gap >= 0
                and (q_gap > 0 or t_gap > 0)
                and q_gap <= merge_distance
                and t_gap <= merge_distance
            ):
                gap_lens, gap_ops = [], []
                if q_gap > 0:
                    gap_lens.append(q_gap)
                    gap_ops.append(cigar.OP_I)
                if t_gap > 0:
                    gap_lens.append(t_gap)
                    gap_ops.append(cigar.OP_D)
                gap_runs = cigar.pack(
                    np.asarray(gap_lens, np.int64), np.asarray(gap_ops, np.uint32)
                )
                if q_fwd:
                    curr.q_last = nxt.q_last
                    curr.t_last = nxt.t_last
                    curr.cigar = np.concatenate([curr.cigar, gap_runs, nxt.cigar])
                else:
                    curr.q_first = nxt.q_first
                    curr.t_first = nxt.t_first
                    curr.cigar = np.concatenate([nxt.cigar, gap_runs, curr.cigar])
                curr.cigar = merge_consecutive_runs(curr.cigar)
                continue

        merged.append(curr)
        curr = nxt

    merged.append(curr)
    results[:] = merged
    return results


def merge_adjusted_intervals_gap_2d(
    results: list[Row], merge_distance: int
) -> list[Row]:
    if len(results) <= 1 or merge_distance < 0:
        return results
    d = merge_distance

    groups: dict[tuple[int, int, bool], list[int]] = {}
    for i, row in enumerate(results):
        strand_fwd = row.q_first <= row.q_last
        groups.setdefault((row.q_id, row.t_id, strand_fwd), []).append(i)

    n = len(results)
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    # PARITY NOTE: the reverse-strand ordering/guard below (sort by
    # -q_first, low-end qa_start/qb_start, `qb_start < qa_start` skip)
    # mirrors the reference verbatim (main.rs:12884-12920) — in practice
    # it only unions overlapping/nested reverse pairs, exactly as there.
    for (_, _, strand_fwd), indices in groups.items():
        indices.sort(
            key=lambda i: results[i].q_first if strand_fwd else -results[i].q_first
        )
        for a_pos, ia in enumerate(indices):
            row_a = results[ia]
            if strand_fwd:
                qa_start, qa_end = row_a.q_first, row_a.q_last
            else:
                qa_start, qa_end = row_a.q_last, row_a.q_first
            ta_start, ta_end = row_a.t_first, row_a.t_last
            for ib in indices[a_pos + 1 :]:
                qb = results[ib]
                qb_start = qb.q_first if strand_fwd else qb.q_last
                if qb_start < qa_start:
                    continue
                q_gap = qb_start - qa_end
                if q_gap > d:
                    break
                tb_start, tb_end = qb.t_first, qb.t_last
                if strand_fwd:
                    t_gap, t_forward = tb_start - ta_end, tb_start > ta_start
                else:
                    t_gap, t_forward = ta_start - tb_end, tb_end < ta_end
                if not t_forward or t_gap > d:
                    continue
                ra, rb = find(ia), find(ib)
                if ra != rb:
                    parent[ra] = rb

    buckets: dict[int, list[int]] = {}
    for i in range(n):
        buckets.setdefault(find(i), []).append(i)

    merged: list[Row] = []
    taken = [False] * n
    for i in range(n):
        if taken[i]:
            continue
        members = buckets.pop(find(i), None)
        if members is None:
            continue
        for m in members:
            taken[m] = True
        first = results[members[0]]
        strand_fwd = first.q_first <= first.q_last
        ordered = sorted(
            members,
            key=lambda idx: results[idx].q_first
            if strand_fwd
            else -results[idx].q_first,
        )
        head = results[ordered[0]]
        q_lo, q_hi = head.q_first, head.q_last
        t_lo, t_hi = head.t_first, head.t_last
        parts = []
        for idx in ordered:
            row = results[idx]
            if strand_fwd:
                q_lo = min(q_lo, row.q_first)
                q_hi = max(q_hi, row.q_last)
            else:
                q_lo = max(q_lo, row.q_first)
                q_hi = min(q_hi, row.q_last)
            t_lo = min(t_lo, row.t_first)
            t_hi = max(t_hi, row.t_last)
            if row.cigar is not None and row.cigar.size:
                parts.append(row.cigar)
        # PARITY NOTE: member CIGARs concatenate with no gap fill, exactly
        # like the reference (main.rs:12987 cigar.extend_from_slice) — the
        # gap-2d merge targets CIGAR-less rows; stats over a stitched
        # CIGAR are best-effort there too.
        runs = (
            merge_consecutive_runs(np.concatenate(parts))
            if parts
            else (np.zeros(0, np.uint32) if head.cigar is not None else None)
        )
        merged.append(Row(head.q_id, q_lo, q_hi, runs, head.t_id, t_lo, t_hi))

    results[:] = merged
    return results
