"""GFA sorting: path-guided 1D SGD + grooming + topological sort — the
gfasort "Ygs" pipeline ('Y' path-SGD order, 'g' groom, 's' priority
topological sort with 1..N renumbering).

The port's copy of impg_tpu/graph/sortgfa.py's columnar path.  The numpy
epoch loop is impg_tpu's, draw for draw, so `sgd_backend="numpy"` writes
impg_tpu's bytes (tests/test_torch_sortgfa.py).  The device backend replaces
the jitted `_sgd_epochs_jax` with ops/path_sgd.sgd_epochs (the K-I kernel on
a CUDA device, its plain twin on the CPU), called with the same arguments.
impg_tpu's dict-model pipeline (`path_sgd_order`, `groom`, `_topo_priority`)
runs there only when its native library is missing; here the native library
is required (graph/gfa_columns.parse_gfa_columns raises without it), so that
pipeline is not copied.  Its `groom` is, for the dict-model fallbacks of
graph/normalize.py and graph/crush.py.  Differences from the copy, each with the same
result:

  * a step that names no S line has node id -1 (sgd_order_columns); numpy's
    `x[-1]` and `np.add.at` wrap it to node n - 1, as `.at[-1]` does in JAX,
    so the id is wrapped once on the host before either backend runs (the
    card would write out of bounds);
  * the first-seen initial positions and the final (x, index) order are
    vectorized (`np.minimum.at`, `np.lexsort`) instead of Python loops over
    the steps and segments;
  * under `auto` a device failure raises: impg_tpu's silent fallback to
    numpy would hide the card.

Backends: "numpy"; "device" (alias "jax", so commands written for impg_tpu
run unchanged); "auto": the device when the update volume (samples x
epochs) reaches AUTO_DEVICE_SAMPLES and the device is usable (CUDA present,
or the caller asked for the CPU), else numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from impg_tpu_torch import tracing

# impg_tpu's `auto` threshold on batch * epochs.
AUTO_DEVICE_SAMPLES = 500_000_000
BACKENDS = ("auto", "numpy", "device", "jax")


def sgd_setup(n, step_node, step_pos, bounds, epochs=30, eta_max=None,
              eta_min=0.01):
    """The layout's starting state: (step_node with negative ids wrapped,
    x0 float64 [n], pstart, pend int64 [n_steps], eta_max, lam)."""
    step_node = np.asarray(step_node, np.int64)
    step_node = np.where(step_node < 0, step_node + n, step_node)
    n_steps = step_node.size
    # Initial positions: first-seen path position per node (stable and
    # already nearly sorted for mostly-linear graphs), by a linear
    # np.minimum.at: an argsort (np.unique) took most of the layout's host
    # time at 11.9M steps.
    first = np.full(n, n_steps, np.int64)
    np.minimum.at(first, step_node, np.arange(n_steps))
    seen = first < n_steps
    x = np.zeros(n, np.float64)
    x[seen] = step_pos[first[seen]]
    if not seen.all():
        x[~seen] = step_pos.max() + 1.0

    # Step index -> its path's [start, end) for in-path partner sampling.
    pstart = np.zeros(n_steps, np.int64)
    pend = np.zeros(n_steps, np.int64)
    for s0, s1 in bounds:
        pstart[s0:s1] = s0
        pend[s0:s1] = s1

    if eta_max is None:
        span = float(step_pos.max() - step_pos.min()) or 1.0
        eta_max = span
    lam = np.log(eta_max / max(eta_min, 1e-9)) / max(epochs - 1, 1)
    return step_node, x, pstart, pend, eta_max, lam


def order_of(x: np.ndarray) -> np.ndarray:
    """Node ordinals by (x[k], k): a stable argsort of x."""
    return np.lexsort((np.arange(x.size), x)).astype(np.int64)


def use_device(backend: str, samples: int, device) -> bool:
    """Whether the layout runs on `device` (K-I, or its twin on the CPU)
    rather than the numpy loop; raises for an unknown backend, and for the
    device backend on a CUDA device when CUDA is absent."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown sgd backend '{backend}' "
                         f"(expected one of {', '.join(BACKENDS)})")
    if backend == "numpy":
        return False
    dev = torch.device(device)
    usable = dev.type == "cpu" or (dev.type == "cuda"
                                   and torch.cuda.is_available())
    if backend in ("device", "jax"):
        if not usable:
            raise ValueError(f"sgd backend '{backend}' needs a CUDA device "
                             f"({dev} is not available)")
        return True
    return usable and samples >= AUTO_DEVICE_SAMPLES


def _sgd_order_core(
    n, step_node, step_pos, bounds, epochs=30, batch_per_step=8,
    eta_max=None, eta_min=0.01, rng=None, backend="auto", device=None,
) -> np.ndarray:
    """Node ordinals ordered by the converged 1D layout.  `device`
    defaults to cuda:0."""
    n_steps = step_node.size
    if n <= 1 or n_steps < 2:
        return np.arange(n)
    rng = rng or np.random.default_rng(42)
    with tracing.span("layout.setup"):
        step_node, x, pstart, pend, eta_max, lam = sgd_setup(
            n, step_node, step_pos, bounds, epochs, eta_max, eta_min)

    batch = n_steps * batch_per_step
    device = torch.device("cuda", 0) if device is None else device
    if use_device(backend, batch * epochs, device):
        from impg_tpu_torch.ops import path_sgd

        x = path_sgd.sgd_epochs(
            x, step_node, step_pos, pstart, pend, epochs, batch,
            float(eta_max), float(lam), device=device,
        )
        with tracing.span("layout.order"):
            return order_of(x)
    with tracing.span("layout.epochs"):
        _numpy_epochs(x, step_node, step_pos, pstart, pend, epochs, batch,
                      eta_max, lam, rng)
    with tracing.span("layout.order"):
        return order_of(x)


def _numpy_epochs(x, step_node, step_pos, pstart, pend, epochs, batch,
                  eta_max, lam, rng) -> None:
    """impg_tpu's numpy epoch loop, updating x in place."""
    n_steps = step_node.size
    for t in range(epochs):
        eta = eta_max * np.exp(-lam * t)
        i = rng.integers(0, n_steps, batch)
        # Zipf-ish partner distance in steps keeps local structure dominant
        # while long jumps still occur.
        off = np.ceil(
            np.exp(rng.uniform(0.0, np.log(n_steps), batch))
        ).astype(np.int64)
        sign = np.where(rng.random(batch) < 0.5, -1, 1)
        j = np.clip(i + sign * off, pstart[i], pend[i] - 1)
        valid = i != j
        i, j = i[valid], j[valid]
        a, b = step_node[i], step_node[j]
        d = np.abs(step_pos[i] - step_pos[j])
        d = np.maximum(d, 1e-9)
        w = 1.0 / (d * d)
        mu = np.minimum(eta * w, 1.0)
        diff = x[a] - x[b]
        mag = np.abs(diff)
        cur = np.where(mag > 1e-9, mag, 1e-9)
        r = (cur - d) / (2.0 * cur) * np.where(mag > 1e-9, 1.0, 0.0)
        dx = mu * r * diff
        # The whole batch applies at once, so average each node's moves
        # (Jacobi-style) — summing conflicting full-strength moves diverges
        # on small dense graphs.
        acc = np.zeros_like(x)
        cnt = np.zeros_like(x)
        np.add.at(acc, a, dx)
        np.subtract.at(acc, b, dx)
        np.add.at(cnt, a, 1.0)
        np.add.at(cnt, b, 1.0)
        x -= acc / np.maximum(cnt, 1.0)


def sgd_inputs(gc):
    """(step_node, step_pos, bounds) of the columnar model: each step's
    segment row (-1 where its name has no S line) and bp midpoint along its
    path, and each path's [start, end) steps."""
    rows = gc.seg_row_of_name()[gc.step_name_idx]
    lens = gc.seg_lens()
    step_node = rows.astype(np.int64)
    step_len = np.where(rows >= 0, lens[np.maximum(rows, 0)], 0).astype(
        np.float64
    )
    # bp midpoint of each step along its path
    ends = np.cumsum(step_len)
    path_base = np.zeros_like(step_len)
    po = gc.path_off
    for p in range(gc.n_paths):
        lo, hi = int(po[p]), int(po[p + 1])
        if lo < hi:
            base = ends[lo - 1] if lo else 0.0
            path_base[lo:hi] = base
    step_pos = ends - path_base - step_len / 2.0
    bounds = [
        (int(po[p]), int(po[p + 1])) for p in range(gc.n_paths)
    ]
    return step_node, step_pos, bounds


def groom(gfa):
    """Flip segments that are majority-reverse across path steps so most
    steps read forward (gfasort 'g' role).  Path spellings are preserved
    exactly: a flipped segment stores its reverse complement and every
    step/link orientation touching it inverts."""
    from impg_tpu_torch.graph.gfa import Gfa
    from impg_tpu_torch.io.fasta import reverse_complement

    rev_votes: dict[str, int] = {}
    fwd_votes: dict[str, int] = {}
    for _, steps in gfa.paths:
        for sid, rev in steps:
            if rev:
                rev_votes[sid] = rev_votes.get(sid, 0) + 1
            else:
                fwd_votes[sid] = fwd_votes.get(sid, 0) + 1
    flip = {
        sid
        for sid in gfa.segments
        if rev_votes.get(sid, 0) > fwd_votes.get(sid, 0)
    }
    if not flip:
        return gfa
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    for sid, seq in gfa.segments.items():
        out.segments[sid] = (
            reverse_complement(seq.encode()).decode() if sid in flip else seq
        )
    out.links = [
        (a, ar ^ (a in flip), b, br ^ (b in flip))
        for a, ar, b, br in gfa.links
    ]
    out.paths = [
        (name, [(sid, rev ^ (sid in flip)) for sid, rev in steps])
        for name, steps in gfa.paths
    ]
    return out


def sgd_order_columns(gc, backend: str = "auto", device=None) -> np.ndarray:
    """Path-SGD segment-row order on the columnar model."""
    with tracing.span("sort.layout", launches=True):
        with tracing.span("layout.inputs"):
            step_node, step_pos, bounds = sgd_inputs(gc)
        return _sgd_order_core(
            gc.n_segs, step_node, step_pos, bounds, backend=backend,
            device=device,
        )


def sort_pipeline(
    gfa_text: str, pipeline: str = "Ygs", sgd_backend: str = "auto",
    device=None,
) -> str:
    """Apply the gfasort-style pipeline on the columnar model (native
    tokenizer + spell/topo kernels): Y = path-SGD order, g = groom,
    s = priority topological sort (+ renumber).  Unknown steps error.
    `device` (default cuda:0) is where a device-backend layout runs.
    Each stage is a span (tracing.py): sort.parse, sort.layout (its own
    layout.* spans), sort.reorder, sort.groom, sort.topo, sort.write, all
    inside sort."""
    from impg_tpu_torch.graph import columnar_ops as co
    from impg_tpu_torch.graph import gfa_columns

    with tracing.span("sort", launches=True):
        with tracing.span("sort.parse"):
            gc = gfa_columns.parse_gfa_columns(gfa_text)
        if gc.n_segs <= 1:
            return gfa_text
        for c in pipeline:
            if c == "Y":
                order = sgd_order_columns(gc, backend=sgd_backend,
                                          device=device)
                with tracing.span("sort.reorder"):
                    gc = co.reorder_segments_columns(
                        gc, np.asarray(order, np.int32))
            elif c == "g":
                with tracing.span("sort.groom"):
                    gc = co.groom_columns(gc)
            elif c == "s":
                with tracing.span("sort.topo"):
                    gc = co.topo_priority_columns(gc)
            else:
                raise ValueError(
                    f"unsupported sort pipeline step '{c}' (expected Y, g, s)"
                )
        with tracing.span("sort.write"):
            return co.write_columns(gc)
