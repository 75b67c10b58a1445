"""The GFA parse of a sort (graph/gfa_columns.py:parse_gfa_columns over
native/gfa_parser.cpp), ms a graph: the program's span `sort.parse`.
Moves sort_s_per_graph."""

from portbench.harness.registry import load_file


def read(ctx):
    return load_file("layers", "_spans").per_graph_ms(("sort.parse",))
