"""Lace: combine per-window GFAs into one graph (reference: commands/lace.rs).

The port's copy of impg_tpu/graph/lace.py: `lace_gfas`, which collected
`partition -o gfa|vcf` laces its per-partition graphs with,
`split_path_name`, which the GAF-to-PAF surjection of `map --graph -o paf`
(genotype/graph.py) reads a path's source frame with, and `lace_files`, the
`lace` command's reader of plain and gzipped GFAs
(tests/test_torch_poa.py and test_torch_graph_cmd.py hold the text equal).

Semantics implemented (lace.rs:214-1100):
  - read S/L/P lines of every input GFA, renumbering nodes into a combined
    graph;
  - parse path names as `NAME:START-END` (split on the LAST ':');
  - per path key: sort ranges by (start, end), drop exact duplicates and
    ranges fully contained in the previous range;
  - trim overlaps between consecutive ranges: leading steps of the later
    range that fall inside the overlap are removed; a single partially
    overlapping step is split (new node with the suffix sequence); more than
    one partial overlap is an error;
  - link contiguous ranges (r1.end == r2.start) with an edge and merge them
    into one path;
  - optional gap filling from a sequence index: a fresh node carrying the
    missing bases joins non-contiguous ranges.

Output paths are named `KEY:START-END` over the merged spans; only nodes
reachable from path steps (plus their edges) are emitted.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RangeInfo:
    start: int
    end: int
    gfa_id: int
    steps: list[tuple[int, bool]]  # (node_id, reverse)


@dataclass
class CombinedGraph:
    sequences: list[bytes] = field(default_factory=list)
    edges: set[tuple[int, bool, int, bool]] = field(default_factory=set)

    def add_node(self, seq: bytes) -> int:
        self.sequences.append(seq)
        return len(self.sequences) - 1

    def node_len(self, node: int) -> int:
        return len(self.sequences[node])


def split_path_name(path_name: str) -> Optional[tuple[str, int, int]]:
    """`NAME:START-END` (split on the LAST ':') -> (NAME, START, END), or
    None when the name carries no integer range."""
    key, sep, rng = path_name.rpartition(":")
    if not sep or "-" not in rng:
        return None
    s, _, e = rng.partition("-")
    try:
        return key, int(s), int(e)
    except ValueError:
        return None


def parse_gfa(text: str):
    """Parse a window GFA -> (nodes {id: seq}, edges, paths).

    Routed through graph/gfa.py Gfa.parse (native tokenizer fast path;
    GFA 1.1 W lines import as range-named paths instead of being
    silently dropped)."""
    from impg_tpu_torch.graph.gfa import Gfa

    g = Gfa.parse(text)
    nodes = {sid: seq.encode() for sid, seq in g.segments.items()}
    return nodes, list(g.links), list(g.paths)


def sort_and_filter_ranges(ranges: list[RangeInfo]) -> None:
    """Sort by (start, end); drop duplicates and fully-contained ranges."""
    ranges.sort(key=lambda r: (r.start, r.end))
    out: list[RangeInfo] = []
    for r in ranges:
        if out:
            prev = out[-1]
            if r.start == prev.start and r.end == prev.end:
                continue
            if r.start >= prev.start and r.end <= prev.end:
                continue
        out.append(r)
    ranges[:] = out


def trim_range_overlaps(ranges: list[RangeInfo], graph: CombinedGraph) -> None:
    """Trim each range's leading coverage already provided by EARLIER
    ranges: everything below the running `cover_end` (max end of all
    previously kept ranges) is removed, and the step crossing the cut is
    split on its ORIENTED sequence (reverse steps slice their reverse
    complement, like the reference's handle-aware get_sequence,
    lace.rs:181).

    Deliberate divergence from lace.rs:678 trim_range_overlaps: the
    reference trims only against the IMMEDIATELY previous range, so a
    three-way overlap both duplicates bases already covered two ranges
    back and silently drops the tail of the split step.  Trimming against
    the running coverage keeps every laced path spelling its source
    exactly (the property our transform fuzz asserts).  For plain
    pairwise overlaps the two formulations behave identically.
    """
    from impg_tpu_torch.io.fasta import reverse_complement

    cover_end = None
    for r2 in ranges:
        if cover_end is None or r2.start >= cover_end:
            cover_end = r2.end if cover_end is None else max(
                cover_end, r2.end
            )
            continue
        cut = min(cover_end, r2.end)

        new_steps: list[tuple[int, bool]] = []
        new_start = None
        pos = r2.start
        for node, rev in r2.steps:
            step_start = pos
            pos += graph.node_len(node)
            step_end = pos
            if step_end <= cut:
                continue  # fully below the cut: already covered
            if step_start >= cut:
                new_steps.append((node, rev))
                if new_start is None:
                    new_start = step_start
                continue
            # Crosses the cut: keep the oriented suffix past it.
            seq = graph.sequences[node]
            oriented = reverse_complement(seq) if rev else seq
            keep = oriented[cut - step_start :]
            if not keep:
                continue
            new_node = graph.add_node(keep)
            new_steps.append((new_node, False))
            if new_start is None:
                new_start = cut
        # Rebuild internal edges along the adjusted path.
        for a, b in zip(new_steps, new_steps[1:]):
            graph.edges.add((a[0], a[1], b[0], b[1]))
        r2.steps = new_steps
        r2.start = new_start if new_start is not None else cut
        cover_end = max(cover_end, r2.end)
        if not new_steps:
            r2.start = r2.end


def link_and_merge(
    key: str,
    ranges: list[RangeInfo],
    graph: CombinedGraph,
    fill_gaps: bool = False,
    sequence_index=None,
) -> list[tuple[str, list[tuple[int, bool]], int, int]]:
    """Link contiguous (or gap-filled) ranges and merge them into paths."""
    merged: list[tuple[str, list[tuple[int, bool]], int, int]] = []
    cur_steps: list[tuple[int, bool]] = []
    cur_start = cur_end = None
    for r in ranges:
        if not r.steps:
            continue
        if cur_steps and cur_end == r.start:
            graph.edges.add((*cur_steps[-1], *r.steps[0]))
            cur_steps.extend(r.steps)
            cur_end = r.end
        elif (
            cur_steps
            and fill_gaps
            and sequence_index is not None
            and r.start > cur_end
        ):
            try:
                gap_seq = sequence_index.fetch_sequence(key, cur_end, r.start)
            except (KeyError, ValueError):
                gap_seq = b"N" * (r.start - cur_end)
            gap_node = graph.add_node(gap_seq)
            graph.edges.add((*cur_steps[-1], gap_node, False))
            graph.edges.add((gap_node, False, *r.steps[0]))
            cur_steps.append((gap_node, False))
            cur_steps.extend(r.steps)
            cur_end = r.end
        else:
            if cur_steps:
                merged.append((key, cur_steps, cur_start, cur_end))
            cur_steps = list(r.steps)
            cur_start, cur_end = r.start, r.end
    if cur_steps:
        merged.append((key, cur_steps, cur_start, cur_end))
    return merged


def lace_gfas(
    gfa_texts: list[str],
    fill_gaps: bool = False,
    sequence_index=None,
) -> str:
    """Combine per-window GFA strings into one laced GFA string."""
    graph = CombinedGraph()
    path_key_ranges: dict[str, list[RangeInfo]] = {}

    for gfa_id, text in enumerate(gfa_texts):
        nodes, edges, paths = parse_gfa(text)
        translation: dict[str, int] = {}
        for old_id, seq in nodes.items():
            translation[old_id] = graph.add_node(seq)
        for a, arev, b, brev in edges:
            if a in translation and b in translation:
                graph.edges.add((translation[a], arev, translation[b], brev))
        for path_name, steps in paths:
            missing = [n for n, _ in steps if n not in translation]
            if missing:
                raise ValueError(
                    f"lace: path '{path_name}' (input #{gfa_id}) references "
                    f"segment(s) with no S line: {missing[:5]}"
                )
            parsed = split_path_name(path_name)
            if parsed is None:
                # Pathological name: treat the whole path as one range at 0.
                key, start = path_name, 0
                end = start + sum(
                    graph.node_len(translation[n]) for n, _ in steps
                )
            else:
                key, start, end = parsed
            path_key_ranges.setdefault(key, []).append(
                RangeInfo(
                    start=start,
                    end=end,
                    gfa_id=gfa_id,
                    steps=[(translation[n], rev) for n, rev in steps],
                )
            )

    merged_paths = []
    for key in path_key_ranges:
        ranges = path_key_ranges[key]
        sort_and_filter_ranges(ranges)
        trim_range_overlaps(ranges, graph)
        merged_paths.extend(
            link_and_merge(key, ranges, graph, fill_gaps, sequence_index)
        )

    # Emit nodes used by paths, renumbered densely; edges between used nodes.
    used: dict[int, int] = {}
    for _, steps, _, _ in merged_paths:
        for node, _ in steps:
            if node not in used:
                used[node] = len(used) + 1
    lines = ["H\tVN:Z:1.0"]
    for node, new_id in used.items():
        lines.append(f"S\t{new_id}\t{graph.sequences[node].decode()}")
    for a, arev, b, brev in sorted(graph.edges):
        if a in used and b in used:
            lines.append(
                f"L\t{used[a]}\t{'-' if arev else '+'}"
                f"\t{used[b]}\t{'-' if brev else '+'}\t0M"
            )
    for key, steps, start, end in merged_paths:
        walk = ",".join(
            f"{used[n]}{'-' if rev else '+'}" for n, rev in steps
        )
        lines.append(f"P\t{key}:{start}-{end}\t{walk}\t*")
    return "\n".join(lines) + "\n"


def lace_files(
    gfa_files: list[str],
    fill_gaps: bool = False,
    sequence_index=None,
) -> str:
    import gzip

    texts = []
    for path in gfa_files:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as fh:
                texts.append(fh.read())
        else:
            with open(path) as fh:
                texts.append(fh.read())
    return lace_gfas(texts, fill_gaps, sequence_index)

