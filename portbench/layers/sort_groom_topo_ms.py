"""The reorder, groom and priority topological sort of a sort
(graph/columnar_ops.py: reorder_segments_columns, groom_columns,
topo_priority_columns), ms a graph: the program's spans `sort.reorder`,
`sort.groom` and `sort.topo`.  Moves sort_s_per_graph."""

from portbench.harness.registry import load_file


def read(ctx):
    return load_file("layers", "_spans").per_graph_ms(
        ("sort.reorder", "sort.groom", "sort.topo"))
