"""Locus boundary refinement: maximize boundary-spanning support.

The port's copy of impg_tpu/commands/refine.py
(tests/test_torch_refine.py holds the two CLIs' bytes equal).  With
`use_transitive_bfs` (`refine -x`) each flank candidate is one transitive
walk through the given engine: the port's CUDA engines run it on the card.

Exact-semantics reimplementation of the reference refine command
(commands/refine.rs:81 `run_refine`): for each input locus, explore a grid of
asymmetric left/right flank expansions (left sweep, then right with left
fixed, then left re-optimized), counting the sequences / PanSN samples /
haplotypes whose merged alignments fully span both region boundaries
(within span_bp), and keep the candidate with (max support, then minimal
expansion, then minimal max-side, then minimal length).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from impg_tpu_torch.index.impg_index import ImpgIndex
from impg_tpu_torch.query import engine
from impg_tpu_torch.query.engine import Row


def extract_pansn_key(name: str, level: str) -> Optional[str]:
    """PanSN aggregation key: sequence (full name), sample (first # field),
    or haplotype (first two # fields)."""
    if level == "sequence":
        return name
    parts = name.split("#")
    if level == "sample":
        return parts[0]
    if level == "haplotype":
        return "#".join(parts[:2]) if len(parts) >= 2 else parts[0]
    return name


@dataclass
class SupportEntity:
    sequence: str
    start: int
    end: int


@dataclass
class RefineRecord:
    chrom: str
    refined_start: int
    refined_end: int
    original_start: int
    original_end: int
    label: str
    applied_left_extension: int
    applied_right_extension: int
    support_count: int
    original_support_count: int
    support_entities: list[SupportEntity] = field(default_factory=list)


@dataclass
class RefineConfig:
    span_bp: int = 1000
    max_extension: float = 0.5
    support_level: str = "sequence"  # sequence | sample | haplotype
    extension_step: int = 1000
    merge_distance: int = 0
    min_identity: Optional[float] = None
    use_transitive_bfs: bool = False
    use_transitive_dfs: bool = False
    max_transitive_depth: int = 2
    min_transitive_len: int = 101
    min_distance_between_ranges: int = 10
    subset_match: Optional[Callable[[str], bool]] = None
    blacklist: Optional[dict[str, list[tuple[int, int]]]] = None


def build_flanks(max_extension: int, step: int) -> list[int]:
    """Flank step grid (refine.rs:852-875)."""
    if max_extension == 0:
        return [0]
    if step <= 0:
        raise ValueError(f"extension step must be positive (got {step})")
    flanks = []
    current = 0
    while current <= max_extension:
        flanks.append(current)
        if max_extension - current < step:
            break
        current += step
    if not flanks or flanks[-1] != max_extension:
        flanks.append(max_extension)
    return sorted(set(flanks))


def _merge_sample_intervals(
    intervals: list[tuple[int, int, int, int]], merge_distance: int
) -> list[tuple[int, int, int, int]]:
    """Merge (q_start, q_end, t_start, t_end) when adjacent on either axis
    (refine.rs:800-851).

    PARITY NOTE: adjacency is min-of-abs endpoint distances per axis,
    exactly as in the reference's should_merge — an overlap of N bp
    counts as distance N (so large overlaps do NOT merge there either).
    """
    if not intervals or merge_distance < 0:
        return intervals
    intervals = sorted(intervals, key=lambda x: (x[0], x[1]))
    merged = [list(intervals[0])]
    for nxt in intervals[1:]:
        cur = merged[-1]
        q_adj = min(abs(cur[1] - nxt[0]), abs(cur[0] - nxt[1])) <= merge_distance
        t_adj = min(abs(cur[3] - nxt[2]), abs(cur[2] - nxt[3])) <= merge_distance
        if q_adj or t_adj:
            cur[0] = min(cur[0], nxt[0])
            cur[1] = max(cur[1], nxt[1])
            cur[2] = min(cur[2], nxt[2])
            cur[3] = max(cur[3], nxt[3])
        else:
            merged.append(list(nxt))
    return [tuple(m) for m in merged]


def _covers_boundaries(
    t_start, t_end, region_start, region_end, left_threshold, right_threshold
) -> bool:
    # PARITY NOTE: the two threshold conditions are implied by the strict
    # bounds, exactly as in the reference (refine.rs:785-797) — span_bp is
    # effectively inert there too.  Kept verbatim for identical output.
    return (
        t_start <= region_start
        and t_end >= region_end
        and t_end >= left_threshold
        and t_start <= right_threshold
    )


def compute_support_sets(
    index: ImpgIndex,
    level: str,
    target_id: int,
    overlaps: list[Row],
    region_start: int,
    region_end: int,
    span_bp: int,
    merge_distance: int,
    blacklist=None,
) -> tuple[set[str], list[SupportEntity]]:
    """Entities whose merged alignments span both boundaries
    (refine.rs:665-784)."""
    aggregated: set[str] = set()
    sequence_ranges: dict[str, tuple[int, int]] = {}
    if len(overlaps) <= 1:
        return aggregated, []

    per_sample: dict[int, list[tuple[int, int, int, int]]] = {}
    for row in overlaps:
        if row.q_id == target_id:
            continue
        q_start, q_end = min(row.q_first, row.q_last), max(row.q_first, row.q_last)
        t_start, t_end = min(row.t_first, row.t_last), max(row.t_first, row.t_last)
        per_sample.setdefault(row.q_id, []).append((q_start, q_end, t_start, t_end))

    effective_span = max(min(max(region_end - region_start, 0), max(span_bp, 0)), 0)
    left_threshold = region_start + effective_span
    right_threshold = region_end - effective_span

    for sample_id in sorted(per_sample):
        merged = _merge_sample_intervals(per_sample[sample_id], merge_distance)
        query_range = None
        for q_start, q_end, t_start, t_end in merged:
            if _covers_boundaries(
                t_start, t_end, region_start, region_end,
                left_threshold, right_threshold,
            ):
                if query_range is None:
                    query_range = (q_start, q_end)
                else:
                    query_range = (
                        min(query_range[0], q_start),
                        max(query_range[1], q_end),
                    )
        if query_range is None:
            continue
        name = index.seq_index.get_name(sample_id)
        if name is None:
            continue
        if blacklist is not None:
            ranges = blacklist.get(name)
            if ranges and any(
                s <= query_range[1] and e >= query_range[0] for s, e in ranges
            ):
                continue
        prev = sequence_ranges.get(name)
        if prev is None:
            sequence_ranges[name] = query_range
        else:
            sequence_ranges[name] = (
                min(prev[0], query_range[0]),
                max(prev[1], query_range[1]),
            )
        key = extract_pansn_key(name, level)
        if key is not None:
            aggregated.add(key)

    survivors = sorted(
        (SupportEntity(seq, s, e) for seq, (s, e) in sequence_ranges.items()),
        key=lambda x: (x.sequence, x.start),
    )
    return aggregated, survivors


def _candidate_key(c) -> tuple:
    """Ordering key for compare_candidates (refine.rs:564): higher support,
    then SMALLER total extension, smaller max side, smaller length."""
    return (
        c["support_count"],
        -(c["left_extension"] + c["right_extension"]),
        -max(c["left_extension"], c["right_extension"]),
        -(c["end"] - c["start"]),
    )


def refine_single_range(
    index: ImpgIndex,
    chrom: str,
    orig_start: int,
    orig_end: int,
    label: str,
    config: RefineConfig,
    device_engine=None,
) -> RefineRecord:
    if orig_end <= orig_start:
        raise ValueError(f"Invalid range {chrom}:{orig_start}-{orig_end}")
    target_id = index.seq_index.get_id(chrom)
    if target_id is None:
        raise ValueError(f"Target sequence '{chrom}' not found in index")
    seq_len = index.seq_index.get_len_from_id(target_id) or 0

    locus_len = max(orig_end - orig_start, 0)
    if config.max_extension <= 1.0:
        import math

        max_extension_bp = int(math.ceil(locus_len * config.max_extension))
    else:
        import math

        max_extension_bp = int(math.ceil(config.max_extension))
    max_extension_bp = max(max_extension_bp, 0)

    flanks = build_flanks(max_extension_bp, config.extension_step)

    def query_overlaps(start: int, end: int) -> list[Row]:
        if config.use_transitive_bfs:
            return engine.query_transitive_bfs(
                index, target_id, start, end,
                max_depth=config.max_transitive_depth,
                min_transitive_len=config.min_transitive_len,
                min_distance_between_ranges=config.min_distance_between_ranges,
                min_identity=config.min_identity,
                subset_match=config.subset_match,
                device_engine=device_engine,
            )
        if config.use_transitive_dfs:
            return engine.query_transitive_dfs(
                index, target_id, start, end,
                max_depth=config.max_transitive_depth,
                min_transitive_len=config.min_transitive_len,
                min_distance_between_ranges=config.min_distance_between_ranges,
                min_identity=config.min_identity,
                subset_match=config.subset_match,
            )
        rows = engine.query(
            index, target_id, start, end, min_identity=config.min_identity
        )
        if config.subset_match is not None:
            rows = [
                r
                for r in rows
                if r.q_id == target_id
                or (
                    index.seq_index.get_name(r.q_id) is not None
                    and config.subset_match(index.seq_index.get_name(r.q_id))
                )
            ]
        return rows

    _eval_cache: dict[tuple[int, int], dict | None] = {}

    def evaluate(left: int, right: int):
        start = max(orig_start - left, 0)
        end = min(orig_end + right, seq_len)
        if (start, end) in _eval_cache:
            return _eval_cache[(start, end)]
        if end <= start:
            _eval_cache[(start, end)] = None
            return None
        overlaps = query_overlaps(start, end)
        aggregated, survivors = compute_support_sets(
            index,
            config.support_level,
            target_id,
            overlaps,
            start,
            end,
            config.span_bp,
            config.merge_distance,
            config.blacklist,
        )
        out = dict(
            start=start,
            end=end,
            left_extension=orig_start - start,
            right_extension=end - orig_end,
            support_count=len(aggregated),
            support_entities=survivors,
        )
        _eval_cache[(start, end)] = out
        return out

    best = evaluate(0, 0)
    original_support = best["support_count"] if best else 0

    def consider(candidate):
        nonlocal best
        if candidate is None:
            return
        if best is None or _candidate_key(candidate) > _candidate_key(best):
            best = candidate

    for left in flanks:
        if left > 0:
            consider(evaluate(left, 0))
    left_fixed = best["left_extension"] if best else 0
    for right in flanks:
        consider(evaluate(left_fixed, right))
    right_fixed = best["right_extension"] if best else 0
    for left in flanks:
        consider(evaluate(left, right_fixed))

    if best is None:
        raise ValueError(
            f"No valid flank sizes evaluated for region {chrom}:{orig_start}-{orig_end}"
        )

    return RefineRecord(
        chrom=chrom,
        refined_start=best["start"],
        refined_end=best["end"],
        original_start=orig_start,
        original_end=orig_end,
        label=label,
        applied_left_extension=best["left_extension"],
        applied_right_extension=best["right_extension"],
        support_count=best["support_count"],
        original_support_count=original_support,
        support_entities=best["support_entities"],
    )


def run_refine(
    index: ImpgIndex,
    ranges: list[tuple[str, tuple[int, int], str]],
    config: RefineConfig,
    device_engine=None,
) -> list[RefineRecord]:
    return [
        refine_single_range(
            index, chrom, start, end, label, config, device_engine
        )
        for chrom, (start, end), label in ranges
    ]


def write_refine_output(records: list[RefineRecord], out, support_out=None) -> None:
    """BED-like output (main.rs:7817-7860)."""
    out.write(
        "#chrom\tstart\tend\tname\toriginal.support\tnew.support"
        "\tleft.extension.bp\tright.extension.bp\n"
    )
    for record in records:
        name_field = record.label
        if not name_field.strip() or name_field == ".":
            name_field = (
                f"{record.chrom}:{record.original_start}-{record.original_end}"
            )
        out.write(
            f"{record.chrom}\t{record.refined_start}\t{record.refined_end}"
            f"\t{name_field}\t{record.original_support_count}"
            f"\t{record.support_count}\t{record.applied_left_extension}"
            f"\t{record.applied_right_extension}\n"
        )
        if support_out is not None:
            for entity in record.support_entities:
                support_out.write(
                    f"{entity.sequence}\t{entity.start}\t{entity.end}"
                    f"\t{name_field}\n"
                )
