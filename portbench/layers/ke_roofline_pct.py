"""K-E (csrc/project_approx.cu) at its share of the roofline over the
window: the least time of every depth's tracepoint projection
(roofline/project_approx.py) over K-E's device time in the trace.  Moves
seeds_per_s."""

from portbench.harness.registry import load_file


def read(ctx):
    lanes = load_file("layers", "_lanes")
    tot = lanes.lane_totals(ctx)
    if tot is None or not ctx.get("approximate"):
        return None
    n_lanes, n_q, n_listed, n_hits = tot
    return lanes.share(ctx, "project_approx",
                       (n_lanes, n_q, n_listed, n_hits, ctx["fields"]))
