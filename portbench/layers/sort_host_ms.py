"""The GFA columnar host stages of a sort (graph/gfa_columns.py,
graph/columnar_ops.py, graph/sortgfa.py outside the layout), ms a graph:
the graph's wall time less the time inside the layout's entry, both from
the benchmark's own wrappers.  Moves sort_s_per_graph."""


def read(ctx):
    walls = ctx.get("graph_walls")
    if not walls:
        return None
    return 1e3 * (sum(walls) - sum(ctx["graph_sgd_s"])) / len(walls)
