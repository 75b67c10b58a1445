"""K-D (csrc/compact.cu) at its share of the roofline over the window: the
least time of every depth's compaction (roofline/compact.py) over K-D's
device time in the trace.  Moves seeds_per_s."""

from portbench.harness.registry import load_file


def read(ctx):
    lanes = load_file("layers", "_lanes")
    tot = lanes.lane_totals(ctx)
    if tot is None:
        return None
    n_lanes, _, _, n_hits = tot
    return lanes.share(ctx, "compact", (n_lanes, n_hits, ctx["fields"]))
