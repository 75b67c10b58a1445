"""The card's idle share of the traced window of a walk cell: 100 x (1 -
the union of kernel, copy and memset intervals over the window).  Moves
seeds_per_s."""


def read(ctx):
    if not ctx.get("batch_walls"):
        return None
    return 100.0 * ctx["trace"].idle_share()
