"""Driver `sort`: `impg sort --pipeline Ygs` (pggb's layout stage) through
`graph.sortgfa.sort_pipeline` on the configuration's locus graph, back to
back.

A step sorts the whole graph, from its GFA text to the sorted GFA text.
Set-up draws the graph and sorts it once, which builds and warms the layout
kernel (K-I) at the graph's shapes.  A wrapper around the layout's entry
keeps the positions each sort's layout returned.  After the window the
sorted graph of one step drawn from the seed, and that of the last step,
are held to the plain reference (reference/sort.py): the same paths
spelled; the segments in the order that the reference's groom and
topological sort give from that step's own layout; and that layout's
stress no more than STRESS_RATIO_LIMIT times the stress of the reference's
own layout, so that any sound layout passes and not only the program's
stream of draws.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness.trace import span
from portbench.reference import sort as ref_sort


# The layout's stress over the reference layout's, on the same pairs: the
# limit lies between the readings of sound runs and of the bfloat16
# control and the planted faults (PERF.md).
STRESS_RATIO_LIMIT = 2.5
# The ratio a checked graph reads when its sort ran no layout.
NO_LAYOUT = 1e12


class LayoutTap:
    """Wraps the program's layout entry (ops/path_sgd.py:sgd_epochs): counts
    its host seconds and keeps the positions it returned last; restores it
    on `close`."""

    def __init__(self, module, traced: bool):
        self.module = module
        self.inner = module.sgd_epochs
        self.traced = traced
        self.seconds = 0.0
        self.last = None
        module.sgd_epochs = self

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        with span("sgd_epochs", self.traced):
            out = self.inner(*args, **kw)
        self.seconds += time.perf_counter() - t0
        self.last = out
        return out

    def close(self) -> None:
        self.module.sgd_epochs = self.inner


def setup(cell, seed: int, device: torch.device, workdir: str,
          traced: bool):
    from impg_tpu_torch.graph import sortgfa
    from impg_tpu_torch.ops import path_sgd

    text = cell.datagen("graph").make(cell.config, seed, workdir)["gfa"]
    st = SimpleNamespace(
        mix=cell.mix, text=text, device=device, traced=traced, seed=seed,
        sort=sortgfa.sort_pipeline, tap=None, sample=
        np.random.default_rng([seed, 2]), n_done=0, kept=None, last=None,
        graph_walls=[], graph_sgd_s=[])
    sort_once(st)
    st.tap = LayoutTap(path_sgd, traced)
    return st


def sort_once(st) -> str:
    out = st.sort(st.text, st.mix["pipeline"],
                  sgd_backend=st.mix["sgd_backend"], device=st.device)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return out


def step(st) -> int:
    t0 = time.perf_counter()
    s0 = st.tap.seconds
    st.tap.last = None
    with span("sort_graph", st.traced):
        out = sort_once(st)
    if st.traced:
        st.graph_walls.append(time.perf_counter() - t0)
        st.graph_sgd_s.append(st.tap.seconds - s0)
    st.n_done += 1
    # One graph of the window, drawn from the seed as it goes (a reservoir
    # of one), and the last, each with its layout.
    got = (out, st.tap.last)
    if st.sample.random() < 1.0 / st.n_done:
        st.kept = got
    st.last = got
    return 1


def end_to_end(st, units: int, window_s: float) -> dict:
    return {"sort_s_per_graph": window_s / units}


def layer_context(st) -> dict:
    g = ref_sort.Graph(st.text)
    return dict(graph_walls=st.graph_walls, graph_sgd_s=st.graph_sgd_s,
                n_steps=int(g.step_row.size), n_segs=g.n_segs,
                epochs=int(st.mix["epochs"]),
                samples_per_step=int(st.mix["samples_per_step"]))


def release(st) -> None:
    if st.tap is not None:
        st.tap.close()
    st.sort = None


def check(st):
    """Over the checked graphs: segments_misplaced and paths_misspelled,
    exact, so their limits are 0; layout_stress_ratio, the largest."""
    g = ref_sort.Graph(st.text)
    x_ref = ref_sort.layout_positions(g, int(st.mix["epochs"]),
                                      int(st.mix["samples_per_step"]),
                                      st.device)
    pairs = ref_sort.stress_pairs(g, st.seed)
    s_ref = ref_sort.stress(x_ref, pairs)
    outs = [st.kept] if st.kept is st.last else [st.kept, st.last]
    tot = {"segments_misplaced": 0, "paths_misspelled": 0}
    ratio = 0.0
    failed = 0
    for out, x in outs:
        if x is None:
            got = ref_sort.compare(g, out, np.full(g.n_segs, -1, np.int64))
            r = NO_LAYOUT
        else:
            got = ref_sort.compare(g, out, ref_sort.sorted_rows(g, x))
            r = ref_sort.stress(x, pairs) / s_ref
            r = r if math.isfinite(r) else NO_LAYOUT
        failed += any(got.values()) or r > STRESS_RATIO_LIMIT
        for k in tot:
            tot[k] += got[k]
        ratio = max(ratio, r)
    checks = [dict(name=k, value=v, limit=0) for k, v in tot.items()]
    checks.append(dict(name="layout_stress_ratio", value=ratio,
                       limit=STRESS_RATIO_LIMIT))
    return checks, failed
