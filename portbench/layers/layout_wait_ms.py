"""The host's wait on K-I and the copy of the positions back
(ops/path_sgd.py:sgd_epochs' `x.cpu()`), ms a graph: the program's span
`layout.readback`.  Moves sort_s_per_graph."""

from portbench.harness.registry import load_file


def read(ctx):
    return load_file("layers", "_spans").per_graph_ms(("layout.readback",))
