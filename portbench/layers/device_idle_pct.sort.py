"""The card's idle share of the traced window of a sort cell: 100 x (1 -
the union of kernel, copy and memset intervals over the window).  Moves
sort_s_per_graph."""


def read(ctx):
    if not ctx.get("graph_walls"):
        return None
    return 100.0 * ctx["trace"].idle_share()
