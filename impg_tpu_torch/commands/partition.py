"""Whole-genome partitioning into homologous loci.

The port's copy of impg_tpu/commands/partition.py, BED and PAF output
(tests/test_torch_partition.py holds the two CLIs' bytes equal).  Its
FASTA, MAF, GFA and VCF writers need the sequence and graph layers, which
the port does not have yet: impg_tpu_torch.cli refuses those formats and
`partition_alignments` raises for them.

Exact-semantics reimplementation of the reference partition command
(commands/partition.rs:158 `partition_alignments`): greedily tile the
pangenome by windowing a starting sequence, transitively querying each window
with the already-masked regions seeding the visited set, merging (-d),
extending to sequence boundaries, subtracting the mask (with proportional
target adjustment and small-fragment absorption), emitting the partition, and
repeating from the largest remaining missing region until everything is
covered.

The transitive queries run through the shared engine (host numpy, the native
C++ engine, or the port's CUDA engines: one walk a window); the bookkeeping
(masked/missing SortedRanges) is host-side, as in the reference.
"""

from __future__ import annotations

import logging
import os
from bisect import bisect_left
from dataclasses import dataclass
from typing import Optional


from impg_tpu_torch.core.intervals import SortedRanges
from impg_tpu_torch.index.impg_index import ImpgIndex
from impg_tpu_torch.query import engine
from impg_tpu_torch.query.engine import Row

log = logging.getLogger(__name__)

# Output formats of impg_tpu's partition that the port writes.
PORTED_FORMATS = ("bed", "paf")


@dataclass
class PartitionInterval:
    """A query-side interval in a partition (first > last = reverse).

    `row` optionally keeps the engine Row the interval came from so writers
    that need the target side (PAF output) can reach it; rehoming moves the
    PartitionInterval wholesale, so the backref follows its partition.
    """

    seq_id: int
    first: int
    last: int
    row: Optional[Row] = None

    def span(self) -> tuple[int, int]:
        return (
            (self.first, self.last)
            if self.first <= self.last
            else (self.last, self.first)
        )


def _window_range(
    windows: list, seq_id: int, start: int, end: int, window_size: int
) -> None:
    """Split [start, end) into window_size windows, merging a small tail into
    the previous window (partition.rs:903-921)."""
    pos = start
    first_emitted = len(windows)
    while pos < end:
        window_end = min(pos + window_size, end)
        if window_end - pos < window_size and len(windows) > first_emitted:
            windows[-1] = (windows[-1][0], windows[-1][1], end)
            break
        windows.append((seq_id, pos, window_end))
        pos = window_end


def select_and_window_sequences(
    windows: list,
    index: ImpgIndex,
    missing_regions: dict[int, SortedRanges],
    selection_mode: str,
    window_size: int,
) -> None:
    """Pick the next region(s) to window (partition.rs:715-938)."""
    ranges_to_window: list[tuple[int, int, int]] = []

    if selection_mode == "longest":
        best = None
        for seq_id, ranges in missing_regions.items():
            for s, e in ranges.ranges:
                key = (e - s, seq_id)
                if best is None or key > (best[3], best[0]):
                    best = (seq_id, s, e, e - s)
        if best is not None:
            ranges_to_window.append((best[0], best[1], best[2]))
    elif selection_mode == "total":
        best = None
        for seq_id, ranges in missing_regions.items():
            total = sum(e - s for s, e in ranges.ranges)
            key = (total, seq_id)
            if best is None or key > best[1:]:
                best = (seq_id, total, seq_id)
        if best is not None:
            seq_len = index.seq_index.get_len_from_id(best[0]) or 0
            ranges_to_window.append((best[0], 0, seq_len))
    elif selection_mode.split(",")[0] in ("sample", "haplotype"):
        parts = selection_mode.split(",", 1)
        field_type = parts[0]
        separator = parts[1] if len(parts) > 1 and parts[1] else "#"
        field_count = 2 if field_type == "haplotype" else 1
        prefix_to_seqs: dict[str, list[int]] = {}
        for seq_id in missing_regions:
            name = index.seq_index.get_name(seq_id)
            if name is None:
                continue
            split = name.split(separator)
            if field_count == 1:
                prefix = split[0]
            else:
                p1 = split[0]
                p2 = split[1] if len(split) > 1 else ""
                prefix = f"{p1}{separator}{p2}"
            prefix_to_seqs.setdefault(prefix, []).append(seq_id)
        if prefix_to_seqs:
            best_prefix, _ = max(
                (
                    (
                        prefix,
                        sum(
                            sum(e - s for s, e in missing_regions[i].ranges)
                            for i in ids
                        ),
                    )
                    for prefix, ids in prefix_to_seqs.items()
                ),
                key=lambda kv: (kv[1], kv[0]),
            )
            seqs = prefix_to_seqs[best_prefix]
            with_len = sorted(
                (
                    (i, index.seq_index.get_len_from_id(i) or 0)
                    for i in seqs
                ),
                key=lambda x: -x[1],
            )
            ranges_to_window.extend((i, 0, l) for i, l in with_len)
    else:
        raise ValueError(
            "Invalid selection mode. Must be 'longest', 'total', "
            "'sample[,sep]', or 'haplotype[,sep]'."
        )

    for seq_id, start, end in ranges_to_window:
        _window_range(windows, seq_id, start, end, window_size)


def merge_overlaps(overlaps: list[Row], merge_distance: int) -> None:
    """Strand-agnostic query-axis merge (partition.rs:939-977)."""
    if len(overlaps) <= 1 or merge_distance < 0:
        return
    overlaps.sort(key=lambda r: (r.q_id, min(r.q_first, r.q_last)))
    out = [overlaps[0]]
    for nxt in overlaps[1:]:
        curr = out[-1]
        curr_min, curr_max = min(curr.q_first, curr.q_last), max(
            curr.q_first, curr.q_last
        )
        next_min, next_max = min(nxt.q_first, nxt.q_last), max(
            nxt.q_first, nxt.q_last
        )
        if curr.q_id != nxt.q_id or next_min > curr_max + merge_distance:
            out.append(nxt)
        else:
            curr.q_first = min(curr_min, next_min)
            curr.q_last = max(curr_max, next_max)
    overlaps[:] = out


def extend_to_close_boundaries(
    overlaps: list[Row], index: ImpgIndex, min_boundary_distance: int
) -> None:
    """Snap near-boundary intervals to the sequence ends (partition.rs:1369)."""
    for row in overlaps:
        seq_len = index.seq_index.get_len_from_id(row.q_id) or 0
        if row.q_first <= row.q_last:
            if row.q_first < min_boundary_distance:
                shift = row.q_first
                row.q_first = 0
                row.t_first -= shift
            if seq_len - row.q_last < min_boundary_distance:
                shift = seq_len - row.q_last
                row.q_last = seq_len
                row.t_last += shift
        else:
            if row.q_last < min_boundary_distance:
                shift = row.q_last
                row.q_last = 0
                row.t_first -= shift
            if seq_len - row.q_first < min_boundary_distance:
                shift = seq_len - row.q_first
                row.q_first = seq_len
                row.t_last += shift


def _search_overlap_start(ranges: list[tuple[int, int]], pos: int) -> int:
    idx = bisect_left(ranges, pos, key=lambda r: r[0])
    if idx > 0 and ranges[idx - 1][1] > pos:
        return idx - 1
    return idx


def mask_and_update_regions(
    overlaps: list[Row],
    masked_regions: dict[int, SortedRanges],
    missing_regions: dict[int, SortedRanges],
    min_fragment_size: int,
    seq_len_of=None,
) -> list[Row]:
    """Subtract the mask from overlaps, absorb small leftover fragments, and
    update masked/missing bookkeeping (partition.rs:978-1368)."""
    if not overlaps:
        return []

    result: list[Row] = []

    def process_sequence(seq_id: int, seq_overlaps: list[Row]) -> None:
        if not seq_overlaps:
            return
        extensions: list[tuple[int, int]] = []
        missing = missing_regions.get(seq_id)
        if missing is not None:
            for row in seq_overlaps:
                mask_start, mask_end = (
                    (row.q_first, row.q_last)
                    if row.q_first <= row.q_last
                    else (row.q_last, row.q_first)
                )
                pos = _search_overlap_start(missing.ranges, mask_start)
                for i in range(pos, len(missing.ranges)):
                    miss_start, miss_end = missing.ranges[i]
                    if miss_start > mask_end:
                        break
                    if (
                        miss_start < mask_start < miss_end
                        and 0 < mask_start - miss_start < min_fragment_size
                    ):
                        extensions.append((miss_start, mask_start))
                    if (
                        miss_start < mask_end < miss_end
                        and 0 < miss_end - mask_end < min_fragment_size
                    ):
                        extensions.append((mask_end, miss_end))

        if extensions:
            extensions.sort(key=lambda x: x[0])
            merged_ext = [extensions[0]]
            for s, e in extensions[1:]:
                if s <= merged_ext[-1][1]:
                    merged_ext[-1] = (merged_ext[-1][0], max(merged_ext[-1][1], e))
                else:
                    merged_ext.append((s, e))
            extensions = merged_ext

        mask_buffer: list[tuple[int, int]] = []
        for row in seq_overlaps:
            q_fwd = row.q_first <= row.q_last
            start, end = (
                (row.q_first, row.q_last) if q_fwd else (row.q_last, row.q_first)
            )
            for ext_start, ext_end in extensions:
                if (ext_end >= start and ext_start <= start) or (
                    ext_start <= end and ext_end >= end
                ):
                    if ext_start < start:
                        start = ext_start
                    if ext_end > end:
                        end = ext_end
            mask_buffer.append((start, end))

            original_span = float(abs(row.q_last - row.q_first))
            new_span = float(end - start)
            scale = new_span / original_span if original_span else 0.0
            target_span = float(row.t_last - row.t_first)
            adj_t_first = row.t_first
            adj_t_last = row.t_first + int(target_span * scale)

            masks = masked_regions.get(seq_id)
            if masks is not None:
                curr_pos = start
                idx = _search_overlap_start(masks.ranges, curr_pos)
                emitted_any = False
                while idx < len(masks.ranges):
                    mask_start, mask_end = masks.ranges[idx]
                    if mask_start > end:
                        break
                    if mask_end <= curr_pos:
                        idx += 1
                        continue
                    if curr_pos < mask_start:
                        seg_ratio = (mask_start - curr_pos) / (end - start)
                        seg_off = (curr_pos - start) / (end - start) * target_span
                        seg_t_span = target_span * seg_ratio
                        nq = (
                            Row(seq_id, curr_pos, mask_start, None, row.t_id,
                                row.t_first + int(seg_off),
                                row.t_first + int(seg_off + seg_t_span))
                            if q_fwd
                            else Row(seq_id, mask_start, curr_pos, None, row.t_id,
                                     row.t_first + int(seg_off),
                                     row.t_first + int(seg_off + seg_t_span))
                        )
                        result.append(nq)
                    curr_pos = max(curr_pos, mask_end)
                    idx += 1
                    if curr_pos >= end:
                        break
                if curr_pos < end:
                    seg_ratio = (end - curr_pos) / (end - start)
                    seg_off = (curr_pos - start) / (end - start) * target_span
                    seg_t_span = target_span * seg_ratio
                    nq = (
                        Row(seq_id, curr_pos, end, None, row.t_id,
                            row.t_first + int(seg_off),
                            row.t_first + int(seg_off + seg_t_span))
                        if q_fwd
                        else Row(seq_id, end, curr_pos, None, row.t_id,
                                 row.t_first + int(seg_off),
                                 row.t_first + int(seg_off + seg_t_span))
                    )
                    result.append(nq)
            else:
                adj = Row(
                    seq_id,
                    start if q_fwd else end,
                    end if q_fwd else start,
                    row.cigar,
                    row.t_id,
                    adj_t_first,
                    adj_t_last,
                )
                result.append(adj)

        if seq_id not in masked_regions:
            # A fresh mask entry must carry the REAL sequence length: the
            # SortedRanges end-snap clamps inserts to sequence_length, so
            # a 0-length default would invert every stored range.
            length = seq_len_of(seq_id) if seq_len_of else 0
            masked_regions[seq_id] = SortedRanges(length or 0, 0)
        masked = masked_regions[seq_id]
        for s, e in mask_buffer:
            masked.insert((s, e))

        missing = missing_regions.get(seq_id)
        if missing is not None:
            masked = masked_regions.get(seq_id)
            if masked is not None:
                original_missing = missing.ranges
                missing.ranges = []
                for miss_start, miss_end in original_missing:
                    current = miss_start
                    idx = _search_overlap_start(masked.ranges, miss_start)
                    while idx < len(masked.ranges) and current < miss_end:
                        mask_start, mask_end = masked.ranges[idx]
                        if mask_start > miss_end:
                            break
                        if mask_end <= current:
                            idx += 1
                            continue
                        if current < mask_start:
                            missing.insert((current, mask_start))
                        current = max(current, mask_end)
                        idx += 1
                    if current < miss_end:
                        missing.insert((current, miss_end))
                if len(missing) == 0:
                    del missing_regions[seq_id]

    # Group rows per sequence regardless of input order: with --no-merge
    # the walker's emission order interleaves sequences, and chunked
    # processing would make fragment-absorption decisions order-dependent
    # (partition.rs:978 processes per sequence).  Stable sort preserves
    # within-sequence emission order.
    ordered = sorted(overlaps, key=lambda r: r.q_id)
    current_seq = ordered[0].q_id
    seq_overlaps: list[Row] = []
    for row in ordered:
        if row.q_id != current_seq:
            process_sequence(current_seq, seq_overlaps)
            seq_overlaps = []
            current_seq = row.q_id
        seq_overlaps.append(row)
    process_sequence(current_seq, seq_overlaps)
    return result


def rehome_singleton_slivers(
    collected: list[tuple[int, list[PartitionInterval]]],
) -> None:
    """Absorb single-interval partitions into adjacent flank partitions
    (partition.rs:45-157)."""
    if not collected:
        return
    rows = []
    for pidx, (_, ivs) in enumerate(collected):
        for iv in ivs:
            s, e = iv.span()
            rows.append([iv.seq_id, s, e, pidx, iv])
    rows.sort(key=lambda r: (r[0], r[1], r[2]))

    counts = [0] * len(collected)
    for r in rows:
        counts[r[3]] += 1
    initial_singletons = sum(1 for c in counts if c == 1)
    if initial_singletons == 0:
        return

    passes = 0
    while True:
        passes += 1
        singletons = {i for i, c in enumerate(counts) if c == 1}
        pending = []
        for i, (c, s, e, pidx, _) in enumerate(rows):
            if pidx not in singletons:
                continue
            left = rows[i - 1][3] if i > 0 and rows[i - 1][0] == c and rows[i - 1][2] == s else None
            right = (
                rows[i + 1][3]
                if i + 1 < len(rows) and rows[i + 1][0] == c and rows[i + 1][1] == e
                else None
            )
            ls = left is not None and left not in singletons
            rs = right is not None and right not in singletons
            if ls and rs:
                target = left if counts[left] >= counts[right] else right
            elif ls:
                target = left
            elif rs:
                target = right
            else:
                continue
            if target != pidx:
                pending.append((i, target))
        if not pending or passes > 100:
            break
        for row_idx, new_pidx in pending:
            counts[rows[row_idx][3]] -= 1
            counts[new_pidx] += 1
            rows[row_idx][3] = new_pidx

    new_intervals: list[list[PartitionInterval]] = [[] for _ in collected]
    for c, s, e, pidx, iv in rows:
        new_intervals[pidx].append(iv)
    rebuilt = []
    for i, (pnum, _) in enumerate(collected):
        if new_intervals[i]:
            rebuilt.append((pnum, new_intervals[i]))
    collected[:] = rebuilt


def partition_alignments(
    index: ImpgIndex,
    window_size: int,
    *,
    starting_sequences_file: Optional[str] = None,
    selection_mode: str = "longest",
    merge_distance: int = 0,
    min_identity: Optional[float] = None,
    min_missing_size: int = 3000,
    min_boundary_distance: int = 3000,
    transitive_dfs: bool = False,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    output_format: str = "bed",
    output_folder: Optional[str] = None,
    separate_files: bool = False,
    rehome_singletons: bool = True,
    device_engine=None,
) -> list[tuple[int, list[PartitionInterval]]]:
    """Run the partition loop; returns [(partition_num, intervals)] and
    writes BED or PAF output as requested."""
    if output_format not in PORTED_FORMATS:
        raise ValueError(
            f"partition output '{output_format}' is not yet ported to "
            f"impg_tpu_torch (ported: {', '.join(PORTED_FORMATS)})"
        )
    n_seqs = len(index.seq_index)
    windows: list[tuple[int, int, int]] = []

    if starting_sequences_file:
        with open(starting_sequences_file) as fh:
            for line in fh:
                name = line.split("\t")[0].strip()
                if not name or name.startswith("#"):
                    continue
                sid = index.seq_index.get_id(name)
                if sid is None:
                    log.debug("Sequence %s from starting file not in index", name)
                    continue
                seq_len = index.seq_index.get_len_from_id(sid) or 0
                _window_range(windows, sid, 0, seq_len, window_size)

    masked_regions = {
        sid: SortedRanges(index.seq_index.get_len_from_id(sid) or 0, 0)
        for sid in range(n_seqs)
    }
    missing_regions = {}
    for sid in range(n_seqs):
        length = index.seq_index.get_len_from_id(sid) or 0
        sr = SortedRanges(length, 0)
        sr.insert((0, length))
        missing_regions[sid] = sr

    total_sequence_length = sum(
        index.seq_index.get_len_from_id(sid) or 0 for sid in range(n_seqs)
    )
    total_partitioned = 0
    partition_num = 0
    collected: list[tuple[int, list[PartitionInterval]]] = []

    if not windows:
        select_and_window_sequences(
            windows, index, missing_regions, selection_mode, window_size
        )

    walker = engine.query_transitive_dfs if transitive_dfs else engine.query_transitive_bfs

    while windows:
        drained, windows = windows, []
        for seq_id, start, end in drained:
            kwargs = dict(
                masked_regions=masked_regions,
                max_depth=max_depth,
                min_transitive_len=min_transitive_len,
                min_distance_between_ranges=min_distance_between_ranges,
                min_output_length=None,
                store_cigar=False,
                min_identity=min_identity,
            )
            if not transitive_dfs:
                kwargs["device_engine"] = device_engine
            overlaps = walker(index, seq_id, start, end, **kwargs)

            merge_overlaps(overlaps, merge_distance)
            if min_boundary_distance > 0:
                extend_to_close_boundaries(overlaps, index, min_boundary_distance)
            overlaps = mask_and_update_regions(
                overlaps, masked_regions, missing_regions, min_missing_size,
                seq_len_of=index.seq_index.get_len_from_id,
            )
            if overlaps:
                merge_overlaps(overlaps, 0)
                keep_rows = output_format == "paf"
                intervals = [
                    PartitionInterval(
                        r.q_id, r.q_first, r.q_last, r if keep_rows else None
                    )
                    for r in overlaps
                ]
                total_partitioned += sum(
                    abs(iv.last - iv.first) for iv in intervals
                )
                if separate_files and output_format == "bed":
                    _write_partition_bed(
                        partition_num, intervals, index, output_folder
                    )
                elif separate_files and output_format == "paf":
                    _write_partition_paf(
                        partition_num, intervals, index, output_folder
                    )
                else:
                    collected.append((partition_num, intervals))
                log.info(
                    "Computed partition%d with %d regions (%d bp total)",
                    partition_num,
                    len(intervals),
                    total_partitioned,
                )
                partition_num += 1

        select_and_window_sequences(
            windows, index, missing_regions, selection_mode, window_size
        )

    if rehome_singletons and not separate_files and collected:
        rehome_singleton_slivers(collected)

    if not separate_files and collected and output_format == "bed":
        _write_single_partition_file(collected, index, output_folder)
    elif not separate_files and collected and output_format == "paf":
        _write_single_partition_paf(collected, index, output_folder)

    log.info(
        "Partitioned into %d regions: %d bp / %d bp total",
        partition_num,
        total_partitioned,
        total_sequence_length,
    )
    return collected


def _output_path(output_folder: Optional[str], filename: str) -> str:
    if output_folder:
        os.makedirs(output_folder, exist_ok=True)
        return os.path.join(output_folder, filename)
    return filename


def _write_partition_bed(
    partition_num: int,
    intervals: list[PartitionInterval],
    index: ImpgIndex,
    output_folder: Optional[str],
) -> None:
    path = _output_path(output_folder, f"partition{partition_num}.bed")
    with open(path, "w") as fh:
        for iv in intervals:
            name = index.seq_index.get_name(iv.seq_id)
            s, e = iv.span()
            fh.write(f"{name}\t{s}\t{e}\n")


def _paf_line(
    index: ImpgIndex, iv: PartitionInterval, extra_tag: str = ""
) -> Optional[str]:
    """One interval-level PAF row for a partition member.

    Extension beyond the reference: partition.rs's writer match
    (partition.rs:1428-1505) has no PAF arm at all — bed/gfa/vcf/maf/fasta
    only.  We emit the projected query↔target interval pair the partition
    member came from.  No cg:Z: is emitted: partition masking rescales
    intervals proportionally (partition.rs:978-1368 semantics), which
    invalidates any base-level CIGAR, so matches/block length are the
    interval-span bounds (min/max of the two spans).
    """
    row = iv.row
    if row is None:
        return None
    qname = index.seq_index.get_name(row.q_id)
    tname = index.seq_index.get_name(row.t_id)
    q_len = index.seq_index.get_len_from_id(row.q_id)
    t_len = index.seq_index.get_len_from_id(row.t_id)
    if row.q_first <= row.q_last:
        qs, qe, strand = row.q_first, row.q_last, "+"
    else:
        qs, qe, strand = row.q_last, row.q_first, "-"
    ts, te = min(row.t_first, row.t_last), max(row.t_first, row.t_last)
    q_span, t_span = qe - qs, te - ts
    matches, block = min(q_span, t_span), max(q_span, t_span)
    return (
        f"{qname}\t{q_len}\t{qs}\t{qe}\t{strand}"
        f"\t{tname}\t{t_len}\t{ts}\t{te}"
        f"\t{matches}\t{block}\t255{extra_tag}\n"
    )


def _write_partition_paf(
    partition_num: int,
    intervals: list[PartitionInterval],
    index: ImpgIndex,
    output_folder: Optional[str],
) -> None:
    path = _output_path(output_folder, f"partition{partition_num}.paf")
    with open(path, "w") as fh:
        for iv in intervals:
            line = _paf_line(index, iv)
            if line is not None:
                fh.write(line)


def _write_single_partition_paf(
    collected: list[tuple[int, list[PartitionInterval]]],
    index: ImpgIndex,
    output_folder: Optional[str],
) -> None:
    path = _output_path(output_folder, "partitions.paf")
    with open(path, "w") as fh:
        for pnum, intervals in collected:
            for iv in intervals:
                line = _paf_line(index, iv, extra_tag=f"\tpn:i:{pnum}")
                if line is not None:
                    fh.write(line)
    log.info("Wrote partitioned PAF to %s", path)


def _write_single_partition_file(
    collected: list[tuple[int, list[PartitionInterval]]],
    index: ImpgIndex,
    output_folder: Optional[str],
) -> None:
    path = _output_path(output_folder, "partitions.bed")
    with open(path, "w") as fh:
        for pnum, intervals in collected:
            for iv in intervals:
                name = index.seq_index.get_name(iv.seq_id)
                s, e = iv.span()
                fh.write(f"{name}\t{s}\t{e}\t{pnum}\n")
