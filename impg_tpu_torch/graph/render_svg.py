"""Native SVG rendering of a GFA graph (reference: main.rs:10990
--render-graph via the external `gfalook` subprocess; here self-contained).

Layout: 1D by topological rank (x = cumulative bp along the sorted order),
lanes (y) chosen greedily so overlapping nodes don't collide; nodes drawn as
rounded rectangles scaled by sequence length and colored by path depth
(mean-depth coloring like gfalook); edges as quadratic curves.

The port's copy of impg_tpu/graph/render_svg.py, behind `render-graph` and
`render --render-graph` (tests/test_torch_gfa_tools.py holds the SVG equal).
"""

from __future__ import annotations

from impg_tpu_torch.graph.gfa import Gfa, topological_sort


def _depth_color(depth: int, max_depth: int) -> str:
    """White -> deep blue ramp by path depth."""
    if max_depth <= 0:
        return "#9ecae1"
    t = min(depth / max_depth, 1.0)
    r = int(247 - t * (247 - 8))
    g = int(251 - t * (251 - 48))
    b = int(255 - t * (255 - 107))
    return f"#{r:02x}{g:02x}{b:02x}"


def render_svg(
    gfa_text: str,
    width: int = 1200,
    lane_height: int = 22,
    min_node_px: float = 2.0,
) -> str:
    gfa = topological_sort(Gfa.parse(gfa_text))
    if not gfa.segments:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"

    # Depth per node.
    depth: dict[str, int] = {}
    for _, steps in gfa.paths:
        for sid, _ in steps:
            depth[sid] = depth.get(sid, 0) + 1
    max_depth = max(depth.values(), default=1)

    # X extents: cumulative bp in topological order, compressed to width.
    total_bp = sum(len(s) for s in gfa.segments.values())
    scale = (width - 40) / max(total_bp, 1)
    x0: dict[str, float] = {}
    x1: dict[str, float] = {}
    cursor = 20.0
    for sid, seq in gfa.segments.items():
        w = max(len(seq) * scale, min_node_px)
        x0[sid] = cursor
        x1[sid] = cursor + w
        cursor += w + 1.5

    # Lane assignment: place branching alternatives on separate lanes.
    lanes: dict[str, int] = {}
    lane_ends: list[float] = []
    for sid in gfa.segments:
        placed = False
        for lane, end in enumerate(lane_ends):
            if end <= x0[sid]:
                lanes[sid] = lane
                lane_ends[lane] = x1[sid]
                placed = True
                break
        if not placed:
            lanes[sid] = len(lane_ends)
            lane_ends.append(x1[sid])
    n_lanes = max(len(lane_ends), 1)
    height = 40 + n_lanes * lane_height

    def ny(sid: str) -> float:
        return 20 + lanes[sid] * lane_height + lane_height / 2

    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{cursor + 20:.0f}' "
        f"height='{height}' viewBox='0 0 {cursor + 20:.0f} {height}'>",
        "<rect width='100%' height='100%' fill='white'/>",
    ]
    # Edges first (under nodes).
    for a, ar, b, br in gfa.links:
        if a not in x0 or b not in x0:
            continue
        xa, ya = x1[a], ny(a)
        xb, yb = x0[b], ny(b)
        midx = (xa + xb) / 2
        parts.append(
            f"<path d='M {xa:.1f} {ya:.1f} Q {midx:.1f} "
            f"{(ya + yb) / 2 + (8 if ya == yb else 0):.1f} {xb:.1f} {yb:.1f}'"
            " fill='none' stroke='#999' stroke-width='0.8'/>"
        )
    # Nodes.
    for sid, seq in gfa.segments.items():
        y = ny(sid) - lane_height / 2 + 3
        color = _depth_color(depth.get(sid, 0), max_depth)
        parts.append(
            f"<rect x='{x0[sid]:.1f}' y='{y:.1f}' "
            f"width='{x1[sid] - x0[sid]:.1f}' height='{lane_height - 6}' "
            f"rx='2' fill='{color}' stroke='#555' stroke-width='0.5'>"
            f"<title>{sid}: {len(seq)} bp, depth {depth.get(sid, 0)}</title>"
            "</rect>"
        )
    parts.append(
        f"<text x='20' y='{height - 8}' font-size='10' fill='#444'>"
        f"{len(gfa.segments)} nodes, {len(gfa.links)} edges, "
        f"{len(gfa.paths)} paths, {total_bp} bp</text>"
    )
    parts.append("</svg>")
    return "\n".join(parts)
