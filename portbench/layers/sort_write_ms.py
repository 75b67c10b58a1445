"""The GFA writer of a sort (graph/columnar_ops.py:write_columns), ms a
graph: the program's span `sort.write`.  Moves sort_s_per_graph."""

from portbench.harness.registry import load_file


def read(ctx):
    return load_file("layers", "_spans").per_graph_ms(("sort.write",))
