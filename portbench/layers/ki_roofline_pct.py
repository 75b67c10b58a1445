"""K-I (csrc/path_sgd.cu) at its share of the roofline over the window:
the least time of every epoch the window ran (roofline/path_sgd.py; bound
by operations) over the device time of K-I's pull and apply launches in the
trace.  Moves sort_s_per_graph."""

from portbench.harness import peaks
from portbench.harness.registry import load_file


def read(ctx):
    if not ctx.get("graph_walls"):
        return None
    roof = load_file("roofline", "path_sgd")
    tr = ctx["trace"]
    dev_s, epochs = 0.0, 0
    for k in roof.KERNELS:
        s, n = tr.kernel_seconds(k)
        dev_s += s
        if k == roof.KERNELS[0]:
            epochs = n
    if epochs == 0 or dev_s <= 0:
        return None
    n_bytes, n_ops = roof.epoch_work(
        ctx["n_steps"], ctx["n_segs"],
        ctx["n_steps"] * ctx["samples_per_step"])
    return 100.0 * epochs * peaks.least_seconds(n_bytes, n_ops) / dev_s
