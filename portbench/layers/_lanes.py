"""Shared by the lane kernels' roofline readers: the work of every depth
the window handed to the engine, and a kernel's share of its roofline."""

from portbench.harness import peaks
from portbench.harness.registry import load_file


def lane_totals(ctx):
    """Summed (lanes, queries, listed lanes, hits) over the window's depth
    calls, or None without calls."""
    calls = ctx.get("calls")
    if not calls:
        return None
    if "_lane_totals" in ctx:
        return ctx["_lane_totals"]
    windows = load_file("roofline", "windows")
    tot = [0, 0, 0, 0]
    for q_tid, q_s, q_e, hits in calls:
        lanes, listed = windows.census(ctx["table"], q_tid, q_s, q_e)
        tot[0] += lanes
        tot[1] += len(q_tid)
        tot[2] += listed
        tot[3] += hits
    ctx["_lane_totals"] = tuple(tot)
    return ctx["_lane_totals"]


def share(ctx, kernel_file: str, work_args) -> float | None:
    """100 x the least time of the window's work over the kernel's device
    time in the trace; None where the kernel never ran."""
    roof = load_file("roofline", kernel_file)
    dev_s, launches = ctx["trace"].kernel_seconds(roof.KERNEL)
    if launches == 0 or dev_s <= 0:
        return None
    n_bytes, n_ops = roof.work(*work_args)
    return 100.0 * peaks.least_seconds(n_bytes, n_ops) / dev_s
