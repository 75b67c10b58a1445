"""Layout glue and K-I's launches (ops/path_sgd.py:sgd_epochs), ms a
graph: the host time spent inside the layout's entry, from the benchmark's
wrapper around it.  Moves sort_s_per_graph."""


def read(ctx):
    walls = ctx.get("graph_walls")
    if not walls:
        return None
    return 1e3 * sum(ctx["graph_sgd_s"]) / len(walls)
