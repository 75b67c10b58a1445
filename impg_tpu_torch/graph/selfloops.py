"""Self-loop run normalization (reference: gfa_self_loops.rs).

Tandem repeats in blunt graphs appear as a node with a direct self-loop edge
that paths traverse k times in a row.  Normalization collapses each run of k
identical consecutive steps through a targeted node into ONE step over a new
run segment whose sequence is unit^k (shared across paths via a (node, k)
key), removes the direct self-loop links of targeted nodes, and adds the
links the transformed path adjacencies need.  Path spellings are verified
unchanged (the reference errors on any difference; so do we).

The port's copy of impg_tpu/graph/selfloops.py (tests/test_torch_graph_pipeline.py
holds the two equal).
"""

from __future__ import annotations

from dataclasses import dataclass

from impg_tpu_torch.graph.gfa import Gfa
from impg_tpu_torch.io.fasta import reverse_complement


@dataclass
class SelfLoopStats:
    input_self_loop_edges: int = 0
    output_self_loop_edges: int = 0
    normalized_nodes: int = 0
    collapsed_runs: int = 0
    created_segments: int = 0
    added_links: int = 0
    removed_self_loop_links: int = 0
    paths_changed: int = 0


def _path_spellings(gfa: Gfa) -> dict[str, bytes]:
    out = {}
    for name, steps in gfa.paths:
        seq = b""
        for sid, rev in steps:
            s = gfa.segments[sid].encode()
            seq += reverse_complement(s) if rev else s
        out[name] = seq
    return out


def diagnose(gfa: Gfa) -> dict:
    self_edges = [l for l in gfa.links if l[0] == l[2]]
    runs = 0
    max_run = 0
    adj_same = 0
    for _, steps in gfa.paths:
        i = 0
        while i < len(steps):
            j = i
            while j + 1 < len(steps) and steps[j + 1] == steps[i]:
                j += 1
            if j > i:
                runs += 1
                max_run = max(max_run, j - i + 1)
                adj_same += j - i
            i = j + 1
    return dict(
        direct_self_loop_edges=len(self_edges),
        direct_self_loop_nodes=len({l[0] for l in self_edges}),
        repeated_path_runs=runs,
        max_repeat_run_len=max_run,
        adjacent_same_step_path_steps=adj_same,
    )


def normalize_self_loops(
    gfa_text: str, max_unit_len: int = 0
) -> tuple[str, SelfLoopStats]:
    gfa = Gfa.parse(gfa_text)
    from impg_tpu_torch.graph import columnar_ops

    before = columnar_ops.path_spellings_of_text(gfa_text)
    if before is None:
        before = _path_spellings(gfa)
    stats = SelfLoopStats()
    stats.input_self_loop_edges = sum(
        1 for l in gfa.links if l[0] == l[2]
    )

    # Targeted nodes: direct self-loop edge or repeated adjacent path steps,
    # under the optional unit-length cap.
    targeted: set[str] = {l[0] for l in gfa.links if l[0] == l[2]}
    for _, steps in gfa.paths:
        for a, b in zip(steps, steps[1:]):
            if a == b:
                targeted.add(a[0])
    if max_unit_len > 0:
        targeted = {
            n for n in targeted if len(gfa.segments.get(n, "")) <= max_unit_len
        }
    targeted = {n for n in targeted if n in gfa.segments}

    run_segments: dict[tuple[str, int], str] = {}
    next_id = (
        max(
            (int(s) for s in gfa.segments if s.isdigit()),
            default=0,
        )
        + 1
    )

    new_paths = []
    for name, steps in gfa.paths:
        out = []
        i = 0
        changed = False
        while i < len(steps):
            sid, rev = steps[i]
            j = i
            while j + 1 < len(steps) and steps[j + 1] == (sid, rev):
                j += 1
            k = j - i + 1
            if k >= 2 and sid in targeted:
                key = (sid, k)
                rid = run_segments.get(key)
                if rid is None:
                    rid = str(next_id)
                    next_id += 1
                    run_segments[key] = rid
                    gfa.segments[rid] = gfa.segments[sid] * k
                    stats.created_segments += 1
                out.append((rid, rev))
                stats.collapsed_runs += 1
                changed = True
            else:
                out.extend(steps[i : j + 1])
            i = j + 1
        if changed:
            stats.paths_changed += 1
        new_paths.append((name, out))
    gfa.paths = new_paths
    stats.normalized_nodes = len({sid for sid, _ in run_segments})

    # Drop direct self-loop links of targeted nodes.
    kept = []
    for l in gfa.links:
        if l[0] == l[2] and l[0] in targeted:
            stats.removed_self_loop_links += 1
            continue
        kept.append(l)
    link_keys = set(kept)
    for _, steps in gfa.paths:
        for (a, ar), (b, br) in zip(steps, steps[1:]):
            key = (a, ar, b, br)
            if key not in link_keys:
                link_keys.add(key)
                kept.append(key)
                stats.added_links += 1
    gfa.links = kept

    out_text = gfa.write()
    ok = columnar_ops.validate_text_spellings(out_text, before)
    if ok is None:
        ok = _path_spellings(Gfa.parse(out_text)) == before
    if not ok:
        raise ValueError(
            "self-loop normalization changed one or more GFA path spellings"
        )
    stats.output_self_loop_edges = sum(
        1 for l in gfa.links if l[0] == l[2]
    )
    return out_text, stats
