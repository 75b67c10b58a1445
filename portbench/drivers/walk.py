"""Driver `walk`: batches of transitive walks, `impg query -b regions.bed
-x`'s batch path, through `query_transitive_bfs_many` on the engine that
`resolve_compute_engine` picks for the index on the card with the native
host engine ruled out: the resident TorchDeviceEngine.  Under plain `auto`
a walk with the default filters goes to the native host engine instead,
and the card does nothing.

A step walks one batch of seed ranges, drawn from the run's seed (each a
range of the mix's span on a sequence drawn uniformly), to the mix's depth;
the batch is done when every walk's rows are on the host.  Set-up draws the
configuration's alignments, builds the program's index and engine (the
upload included) and walks one batch of its own, which warms every kernel
and buffer the window uses.

What the window produces is judged after it: a sample of its walks drawn
from the seed (one walk a batch, at most CHECKED of them, each batch's as
likely as any other's), and the window's walk with the most rows, each
against the plain reference walk (reference/walk.py) as a multiset of rows.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness.trace import span
from portbench.reference import walk as ref_walk

# Walks of the window held to the reference, besides the one with the most
# rows: a uniform sample of one walk a batch (a reservoir).
CHECKED = 24


class Recorder:
    """Engine proxy: each query batch the walk hands to the engine, the hits
    it returned, and the host seconds spent inside the engine's stream."""

    def __init__(self, engine, traced: bool):
        self.engine = engine
        self.traced = traced
        self.calls: list = []
        self.engine_s = 0.0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def query_batch_stream(self, q_tid, q_s, q_e, **kw):
        call = [np.array(q_tid, np.int64), np.array(q_s, np.int64),
                np.array(q_e, np.int64), 0]
        self.calls.append(call)
        it = self.engine.query_batch_stream(q_tid, q_s, q_e, **kw)
        while True:
            t0 = time.perf_counter()
            with span("engine_stream", self.traced):
                out = next(it, None)
            self.engine_s += time.perf_counter() - t0
            if out is None:
                return
            call[3] += int(np.asarray(out["pair_q"]).size)
            yield out


def draw_batch(rng, lengths: np.ndarray, batch: int, span_bp) -> list:
    """Seed ranges as bench.py's scale tier draws them, in three vectorized
    draws: a sequence, a span in [lo, hi), a start that keeps the range
    inside the sequence."""
    lo, hi = span_bp
    sid = rng.integers(lengths.size, size=batch)
    width = rng.integers(lo, hi, size=batch)
    start = rng.integers(0, lengths[sid] - width)
    return list(zip(sid.tolist(), start.tolist(), (start + width).tolist()))


def setup(cell, seed: int, device: torch.device, workdir: str,
          traced: bool):
    from impg_tpu_torch import cli
    from impg_tpu_torch.query import device as qdev
    from impg_tpu_torch.query import engine as engine_mod

    mix = cell.mix
    data = cell.datagen("alignments").make(cell.config, seed, workdir)
    index = data["index"]
    approx = bool(mix["approximate"])
    if "paf" in data:
        chunks, names, lengths = ref_walk.parse_paf(data["paf"])
    else:
        chunks, names, lengths = data["chunks"], data["names"], data["lengths"]
    table = ref_walk.DirectedTable(chunks, names, lengths)
    if device.type == "cuda":
        engine = cli.resolve_compute_engine(
            SimpleNamespace(compute_engine="auto"), index,
            approximate=approx, n_targets=int(mix["batch"]),
            native_ok=False, device=device)
    else:
        engine = qdev.TorchDeviceEngine(index, device,
                                        with_tracepoints=approx)
    if type(engine).__name__ != "TorchDeviceEngine":
        raise RuntimeError(f"the resolver picked {type(engine).__name__}, "
                           "not the resident TorchDeviceEngine")
    # Program sequence ids of the reference's names, and back.
    prog_of_ref = np.array([index.seq_index.get_id(n) for n in names],
                           np.int64)
    ref_of_prog = np.full(len(index.seq_index), -1, np.int64)
    ref_of_prog[prog_of_ref] = np.arange(len(names))
    st = SimpleNamespace(
        cell=cell, mix=mix, index=index, table=table, approx=approx,
        engine=Recorder(engine, traced) if traced else engine,
        bfs=engine_mod.query_transitive_bfs_many,
        lengths=np.asarray(lengths, np.int64), prog_of_ref=prog_of_ref,
        ref_of_prog=ref_of_prog, traced=traced, device=device,
        batches=np.random.default_rng([seed, 1]),
        sample=np.random.default_rng([seed, 2]),
        kept=[], n_batches=0, largest=None, batch_walls=[],
        batch_engine_s=[])
    walk(st, draw_batch(np.random.default_rng([seed, 0]), st.lengths,
                        int(mix["batch"]), mix["span_bp"]))
    if traced:
        st.engine.calls.clear()
        st.engine.engine_s = 0.0
    return st


def walk(st, targets: list) -> list:
    """The program's walks of `targets` (reference sequence ids)."""
    mix = st.mix
    prog = [(int(st.prog_of_ref[t]), s, e) for t, s, e in targets]
    blocks = st.bfs(
        st.index, prog, max_depth=int(mix["max_depth"]),
        min_transitive_len=int(mix["min_transitive_len"]),
        min_distance_between_ranges=int(mix["min_distance_between_ranges"]),
        device_engine=st.engine, approximate=st.approx, columnar=True)
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
    return blocks


def step(st) -> int:
    targets = draw_batch(st.batches, st.lengths, int(st.mix["batch"]),
                         st.mix["span_bp"])
    t0 = time.perf_counter()
    e0 = st.engine.engine_s if st.traced else 0.0
    with span("walk_batch", st.traced):
        blocks = walk(st, targets)
    if st.traced:
        st.batch_walls.append(time.perf_counter() - t0)
        st.batch_engine_s.append(st.engine.engine_s - e0)
    st.n_batches += 1
    j = int(st.sample.integers(len(targets)))
    if len(st.kept) < CHECKED:
        st.kept.append((targets[j], blocks[j]))
    else:
        r = int(st.sample.integers(st.n_batches))
        if r < CHECKED:
            st.kept[r] = (targets[j], blocks[j])
    big = max(range(len(blocks)), key=lambda i: len(blocks[i]))
    if st.largest is None or len(blocks[big]) > len(st.largest[1]):
        st.largest = (targets[big], blocks[big])
    return len(targets)


def end_to_end(st, units: int, window_s: float) -> dict:
    return {"seeds_per_s": units / window_s}


def layer_context(st) -> dict:
    """What the per-layer readers read: the benchmark's spans and counts of
    the window, and the reference's record table for the work counts."""
    return dict(batch_walls=st.batch_walls,
                batch_engine_s=st.batch_engine_s,
                calls=st.engine.calls, table=st.table,
                fields=6, approximate=st.approx)


def release(st) -> None:
    st.engine = None
    st.index = None


def reference_args(mix: dict) -> dict:
    """The reference walk's arguments for a mix."""
    return dict(max_depth=int(mix["max_depth"]),
                min_transitive_len=int(mix["min_transitive_len"]),
                min_distance=int(mix["min_distance_between_ranges"]),
                spacing=(int(mix["tracepoint_spacing"]) if mix["approximate"]
                         else None))


def check(st):
    """rows_off: rows in the program's or the reference's multiset and not
    the other's, over the checked walks; exact, so its limit is 0."""
    walks = list(st.kept)
    if st.largest is not None:
        walks.append(st.largest)
    mix = st.mix
    off = 0
    failed = 0
    for (tid, s, e), block in walks:
        got = np.stack([np.asarray(block.q_id, np.int64),
                        np.asarray(block.q_first, np.int64),
                        np.asarray(block.q_last, np.int64),
                        np.asarray(block.t_id, np.int64),
                        np.asarray(block.t_first, np.int64),
                        np.asarray(block.t_last, np.int64)], 1)
        got[:, 0] = st.ref_of_prog[got[:, 0]]
        got[:, 3] = st.ref_of_prog[got[:, 3]]
        want = st.table.walk(tid, s, e, **reference_args(mix))
        n = ref_walk.rows_off(got, want)
        off += n
        failed += n > 0
    return [dict(name="rows_off", value=off, limit=0)], failed
