"""Shared by the readers of the program's own spans
(impg_tpu_torch/tracing.py, on while the profiler records the window): ms a
graph of a set of spans over the window's sorts."""

import importlib


def per_graph_ms(names):
    """The summed total time of the spans `names` over the calls of the
    span `sort`, in ms; None where the program has no tracing module or
    recorded no sort."""
    try:
        tracing = importlib.import_module("impg_tpu_torch.tracing")
    except ImportError:
        return None
    tot = tracing.totals()
    sorts = tot.get("sort", {}).get("calls", 0)
    if not sorts:
        return None
    return sum(tot[n]["total_ns"] for n in names if n in tot) / 1e6 / sorts
