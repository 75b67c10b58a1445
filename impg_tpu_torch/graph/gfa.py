"""GFA dict model: parse (S/L/P, and GFA 1.1 W lines), write and report.

The port's copy of impg_tpu/graph/gfa.py's `Gfa.parse`, `Gfa.parse_python`,
`Gfa.write`, `topological_sort` (the `sort` stage of `-o gfa:`, stable Kahn
order with renumbering), `_numeric_key`, `report` and `report_text` (the
graph characterization of `graph-report`: node/edge/path counts, length and
degree distributions, per-node path depth buckets), `chop_gfa` (smooth's
chop), `_parse_w_walk` and `_split_walk_name`.  `parse` tokenizes
through the port's native GFA parser (graph/gfa_columns.py) and falls back
to `parse_python`, the tokenizer-free oracle, only where impg_tpu's does:
when the native library is not there.  Graph genotyping and `map --graph`
(genotype/graph.py) read their graphs with `parse`; the `sort` path runs on
the columnar model and needs only `_split_walk_name` (the W-line names of
graph/columnar_ops.write_columns).  `report` is the oracle of
gfa_columns.report_columns, which `graph-report` runs.  Blunt GFAs (0M
overlaps).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field


@dataclass
class Gfa:
    segments: dict[str, str] = field(default_factory=dict)  # id -> seq
    links: list[tuple[str, bool, str, bool]] = field(default_factory=list)
    paths: list[tuple[str, list[tuple[str, bool]]]] = field(default_factory=list)
    header: str = "H\tVN:Z:1.0"
    # Names of paths imported from GFA 1.1 W lines (re-emitted as W).
    walk_names: set = field(default_factory=set)

    @classmethod
    def parse(cls, text: str) -> "Gfa":
        """The dict model of `text` through the native tokenizer; a bad W
        walk raises ValueError.  Without the native library (RuntimeError
        from the tokenizer) the pure-Python parse gives the same object."""
        from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

        try:
            gc = parse_gfa_columns(text)
        except RuntimeError:
            return cls.parse_python(text)
        return gc.to_gfa()

    @classmethod
    def parse_python(cls, text: str) -> "Gfa":
        """Pure-Python parse (the oracle for the native tokenizer)."""
        g = cls()
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            f = line.split("\t")
            if f[0] == "H":
                g.header = line
            elif f[0] == "S" and len(f) >= 3:
                g.segments[f[1]] = f[2]
            elif f[0] == "L" and len(f) >= 6:
                g.links.append((f[1], f[2] == "-", f[3], f[4] == "-"))
            elif f[0] == "P" and len(f) >= 3:
                steps = [(s[:-1], s.endswith("-")) for s in f[2].split(",") if s]
                g.paths.append((f[1], steps))
            elif f[0] == "W" and len(f) >= 7:
                # GFA 1.1 walk: W sample hap seq start end >1<2...
                # Imported as a path named PanSN-style with the range.
                name = f"{f[1]}#{f[2]}#{f[3]}:{f[4]}-{f[5]}"
                steps = _parse_w_walk(f[6])
                g.paths.append((name, steps))
                g.walk_names.add(name)
        return g

    def write(self) -> str:
        lines = [self.header]
        for sid, seq in self.segments.items():
            lines.append(f"S\t{sid}\t{seq}")
        for a, ar, b, br in self.links:
            lines.append(
                f"L\t{a}\t{'-' if ar else '+'}\t{b}\t{'-' if br else '+'}\t0M"
            )
        for name, steps in self.paths:
            if name in self.walk_names:
                parsed = _split_walk_name(name)
                if parsed is not None:
                    sample, hap, seq, start, end = parsed
                    walk = "".join(
                        f"{'<' if r else '>'}{s}" for s, r in steps
                    )
                    lines.append(
                        f"W\t{sample}\t{hap}\t{seq}\t{start}\t{end}\t{walk}"
                    )
                    continue
            walk = ",".join(f"{s}{'-' if r else '+'}" for s, r in steps)
            lines.append(f"P\t{name}\t{walk}\t*")
        return "\n".join(lines) + "\n"


def topological_sort(gfa: Gfa) -> Gfa:
    """Renumber segments 1..N in stable topological order (links treated as
    undirected-orientation DAG edges from->to; cycles broken by input order)."""
    order: list[str] = []
    indeg: dict[str, int] = {sid: 0 for sid in gfa.segments}
    succs: dict[str, list[str]] = {sid: [] for sid in gfa.segments}
    for a, _, b, _ in gfa.links:
        if a in indeg and b in indeg and a != b:
            succs[a].append(b)
            indeg[b] += 1
    ready = sorted(
        (sid for sid, d in indeg.items() if d == 0),
        key=lambda s: _numeric_key(s),
    )
    seen = set()
    while ready:
        v = ready.pop(0)
        if v in seen:
            continue
        seen.add(v)
        order.append(v)
        newly = []
        for w in succs[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                newly.append(w)
        ready.extend(sorted(newly, key=_numeric_key))
    # Cycle remnants: append in input order.
    for sid in gfa.segments:
        if sid not in seen:
            order.append(sid)

    rename = {old: str(i + 1) for i, old in enumerate(order)}
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    for old in order:
        out.segments[rename[old]] = gfa.segments[old]
    out.links = [
        (rename[a], ar, rename[b], br)
        for a, ar, b, br in gfa.links
        if a in rename and b in rename
    ]
    out.paths = [
        (name, [(rename[s], r) for s, r in steps if s in rename])
        for name, steps in gfa.paths
    ]
    return out


def _numeric_key(s: str):
    try:
        return (0, int(s), "")
    except ValueError:
        return (1, 0, s)


def report(gfa: Gfa) -> dict:
    """Graph characterization metrics (graph_report.rs core)."""
    n_nodes = len(gfa.segments)
    node_lens = [len(s) for s in gfa.segments.values()]
    total_len = sum(node_lens)
    degree_out: dict[str, int] = {}
    degree_in: dict[str, int] = {}
    for a, _, b, _ in gfa.links:
        degree_out[a] = degree_out.get(a, 0) + 1
        degree_in[b] = degree_in.get(b, 0) + 1

    depth: dict[str, int] = {}
    path_lens = []
    for _, steps in gfa.paths:
        plen = 0
        for sid, _ in steps:
            depth[sid] = depth.get(sid, 0) + 1
            plen += len(gfa.segments.get(sid, ""))
        path_lens.append(plen)

    depth_values = [depth.get(sid, 0) for sid in gfa.segments]
    buckets = {"0": 0, "1": 0, "2-4": 0, "5-9": 0, "10+": 0}
    for d in depth_values:
        if d == 0:
            buckets["0"] += 1
        elif d == 1:
            buckets["1"] += 1
        elif d < 5:
            buckets["2-4"] += 1
        elif d < 10:
            buckets["5-9"] += 1
        else:
            buckets["10+"] += 1

    def stats(vals):
        if not vals:
            return dict(min=0, max=0, mean=0.0, median=0)
        sv = sorted(vals)
        return dict(
            min=sv[0],
            max=sv[-1],
            mean=round(sum(sv) / len(sv), 2),
            median=sv[len(sv) // 2],
        )

    branching = sum(
        1 for sid in gfa.segments if degree_out.get(sid, 0) > 1
    )
    merging = sum(1 for sid in gfa.segments if degree_in.get(sid, 0) > 1)

    # Rare repeated local contexts (graph_report.rs:2058
    # local_repeat_contexts): nodes whose (left, right) step context is
    # dominated by one pattern with only a few minor occurrences — likely
    # collapse artifacts worth inspecting.
    max_minor, min_dominance = 2, 0.80
    ctx_counts: dict[str, dict[tuple[str, str], int]] = {}

    def lbl(st):
        return st[0] + ("-" if st[1] else "+")

    for _, steps in gfa.paths:
        for i, st in enumerate(steps):
            left = lbl(steps[i - 1]) if i > 0 else "^"
            right = lbl(steps[i + 1]) if i + 1 < len(steps) else "$"
            ctx_counts.setdefault(lbl(st), {}).setdefault(
                (left, right), 0
            )
            ctx_counts[lbl(st)][(left, right)] += 1
    repeat_contexts = []
    for node, counts in ctx_counts.items():
        if len(counts) <= 1:
            continue
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if len(ranked) > 1 and ranked[0][1] == ranked[1][1]:
            continue
        total = sum(c for _, c in ranked)
        (dl, dr), dom = ranked[0]
        minor = total - dom
        if minor <= max_minor and dom / total >= min_dominance:
            repeat_contexts.append(
                dict(
                    node=node,
                    total_occurrences=total,
                    dominant_count=dom,
                    minor_occurrences=minor,
                    dominant_fraction=round(dom / total, 4),
                    dominant_left=dl,
                    dominant_right=dr,
                )
            )
    repeat_contexts.sort(
        key=lambda c: (-c["minor_occurrences"], -c["total_occurrences"])
    )
    repeat_contexts = repeat_contexts[:5]

    # Connected components over the undirected link graph + tips
    # (graph_report.rs components/tips metrics).
    parent: dict[str, str] = {sid: sid for sid in gfa.segments}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, _, b, _ in gfa.links:
        if a in parent and b in parent:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb
    comp_sizes: dict[str, int] = {}
    for sid in gfa.segments:
        r = find(sid)
        comp_sizes[r] = comp_sizes.get(r, 0) + 1
    largest = max(comp_sizes.values()) if comp_sizes else 0
    tips = sum(
        1
        for sid in gfa.segments
        if degree_in.get(sid, 0) == 0 or degree_out.get(sid, 0) == 0
    )

    # Duplicate-sequence groups (graph_report.rs duplicate_sequence_*):
    # identical node DNA (strand-canonical) occurring in >1 node.
    from impg_tpu_torch.io.fasta import reverse_complement

    by_seq: dict[bytes, int] = {}
    for s in gfa.segments.values():
        b = s.encode()
        canon = min(b, reverse_complement(b))
        by_seq[canon] = by_seq.get(canon, 0) + 1
    dup_groups = sum(1 for c in by_seq.values() if c > 1)
    dup_nodes = sum(c for c in by_seq.values() if c > 1)

    # Coverage shape: percentiles, singleton/high-coverage mass
    # (graph_report.rs node_coverage_* / singleton_* / high_coverage_*).
    def pctl(sv, q):
        if not sv:
            return 0
        return sv[min(int(q * (len(sv) - 1)), len(sv) - 1)]

    dv_sorted = sorted(depth_values)
    n_paths = max(len(gfa.paths), 1)
    high_thr = max(2 * n_paths, 10)
    singleton_nodes = sum(1 for d in depth_values if d == 1)
    singleton_bp = sum(
        len(s)
        for sid, s in gfa.segments.items()
        if depth.get(sid, 0) == 1
    )
    high_nodes = sum(1 for d in depth_values if d >= high_thr)
    high_bp = sum(
        len(s)
        for sid, s in gfa.segments.items()
        if depth.get(sid, 0) >= high_thr
    )

    # 1D jump profiles over numeric node ids (graph_report.rs link_jump_* /
    # path_jump_*): long jumps flag poor sorts / distant tangles.
    def _nid(s: str):
        try:
            return int(s)
        except ValueError:
            return None

    link_jumps = sorted(
        abs(_nid(a) - _nid(b))
        for a, _, b, _ in gfa.links
        if _nid(a) is not None and _nid(b) is not None
    )
    path_jumps = []
    for _, steps in gfa.paths:
        for (a, _), (b, _) in zip(steps, steps[1:]):
            na, nb = _nid(a), _nid(b)
            if na is not None and nb is not None:
                path_jumps.append(abs(nb - na))
    path_jumps.sort()

    return {
        "nodes": n_nodes,
        "edges": len(gfa.links),
        "paths": len(gfa.paths),
        "total_segment_bp": total_len,
        "node_length": stats(node_lens),
        "path_length_bp": stats(path_lens),
        "node_depth": stats(depth_values),
        "depth_buckets": buckets,
        "branching_nodes": branching,
        "merging_nodes": merging,
        "repeat_contexts": repeat_contexts,
        "components": len(comp_sizes),
        "largest_component_nodes": largest,
        "largest_component_frac": round(largest / max(n_nodes, 1), 4),
        "tips": tips,
        "duplicate_sequence_groups": dup_groups,
        "duplicate_sequence_nodes": dup_nodes,
        "coverage_p10": pctl(dv_sorted, 0.10),
        "coverage_median": pctl(dv_sorted, 0.50),
        "coverage_p90": pctl(dv_sorted, 0.90),
        "singleton_nodes": singleton_nodes,
        "singleton_bp": singleton_bp,
        "high_coverage_threshold": high_thr,
        "high_coverage_nodes": high_nodes,
        "high_coverage_bp": high_bp,
        "link_jump_p95": pctl(link_jumps, 0.95),
        "link_jump_max": link_jumps[-1] if link_jumps else 0,
        "path_jump_p95": pctl(path_jumps, 0.95),
        "path_jump_max": path_jumps[-1] if path_jumps else 0,
        "mean_depth": round(
            sum(d * len(gfa.segments.get(s, "")) for s, d in depth.items())
            / total_len,
            3,
        )
        if total_len
        else 0.0,
    }


def report_text(rep: dict, fmt: str = "md") -> str:
    if fmt == "json":
        return json.dumps(rep, indent=2) + "\n"
    if fmt == "tsv":
        lines = []

        def flat(prefix, obj):
            for k, v in obj.items():
                if isinstance(v, dict):
                    flat(f"{prefix}{k}.", v)
                elif isinstance(v, list):
                    lines.append(f"{prefix}{k}\t{json.dumps(v)}")
                else:
                    lines.append(f"{prefix}{k}\t{v}")

        flat("", rep)
        return "\n".join(lines) + "\n"
    # markdown
    out = ["# Graph report", ""]
    out.append(f"- nodes: {rep['nodes']}")
    out.append(f"- edges: {rep['edges']}")
    out.append(f"- paths: {rep['paths']}")
    out.append(f"- total segment bp: {rep['total_segment_bp']}")
    out.append(f"- mean path depth (bp-weighted): {rep['mean_depth']}")
    out.append(
        f"- node length: min {rep['node_length']['min']}, "
        f"median {rep['node_length']['median']}, max {rep['node_length']['max']}"
    )
    out.append(
        f"- branching nodes: {rep['branching_nodes']}, "
        f"merging nodes: {rep['merging_nodes']}"
    )
    out.append("- depth buckets: " + ", ".join(
        f"{k}: {v}" for k, v in rep["depth_buckets"].items()
    ))
    if rep.get("repeat_contexts"):
        out.append("- rare repeated-context nodes:")
        for c in rep["repeat_contexts"]:
            out.append(
                f"  - {c['node']}: {c['total_occurrences']} occurrences, "
                f"dominant {c['dominant_left']} .. {c['dominant_right']} "
                f"({c['dominant_fraction']:.0%}), "
                f"{c['minor_occurrences']} minor"
            )
    return "\n".join(out) + "\n"



def chop_gfa(gfa: Gfa, max_len: int) -> Gfa:
    """Split segments longer than `max_len` into consecutive pieces
    (smooth.rs:332 chop_graph role; odgi-chop semantics).  Path steps
    expand in walk order — reverse steps traverse the pieces backwards
    with flipped orientation — and links regenerate from the paths, so
    every path spells exactly the same bases."""
    if max_len <= 0:
        return gfa
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    pieces: dict[str, list[str]] = {}
    next_id = 1
    for sid, seq in gfa.segments.items():
        ids = []
        for off in range(0, max(len(seq), 1), max_len):
            nid = str(next_id)
            next_id += 1
            out.segments[nid] = seq[off : off + max_len]
            ids.append(nid)
        pieces[sid] = ids
    link_set: set[tuple[str, bool, str, bool]] = set()
    for name, steps in gfa.paths:
        new_steps: list[tuple[str, bool]] = []
        for sid, rev in steps:
            ids = pieces[sid]
            new_steps.extend(
                (p, rev) for p in (reversed(ids) if rev else ids)
            )
        out.paths.append((name, new_steps))
        for (a, ar), (b, br) in zip(new_steps, new_steps[1:]):
            link_set.add((a, ar, b, br))
    out.links = sorted(link_set, key=lambda l: (_numeric_key(l[0]), l[1],
                                                _numeric_key(l[2]), l[3]))
    return out


def _parse_w_walk(walk: str) -> list[tuple[str, bool]]:
    """'>1<2' oriented steps of a GFA 1.1 W line."""
    steps: list[tuple[str, bool]] = []
    i = 0
    while i < len(walk):
        orient = walk[i]
        if orient not in "><":
            raise ValueError(f"invalid W walk orientation at {i}: {walk}")
        j = i + 1
        while j < len(walk) and walk[j] not in "><":
            j += 1
        steps.append((walk[i + 1 : j], orient == "<"))
        i = j
    return steps


def _split_walk_name(name: str):
    """sample#hap#seq:start-end back into W-line fields, or None."""
    base, _, rng = name.rpartition(":")
    parts = base.split("#")
    if len(parts) != 3 or "-" not in rng:
        return None
    s, _, e = rng.partition("-")
    try:
        return parts[0], parts[1], parts[2], int(s), int(e)
    except ValueError:
        return None
