"""The layout's host preparation (graph/sortgfa.py:sgd_inputs, sgd_setup,
order_of; ops/path_sgd.py's packing of the step columns), ms a graph: the
program's spans `layout.inputs`, `layout.setup`, `layout.pack` and
`layout.order`.  Moves sort_s_per_graph."""

from portbench.harness.registry import load_file


def read(ctx):
    return load_file("layers", "_spans").per_graph_ms(
        ("layout.inputs", "layout.setup", "layout.pack", "layout.order"))
