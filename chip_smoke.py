#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (impg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises and exits non-zero.
Each main path runs with the launch counts zeroed just before it and read
just after, and fails unless every kernel of that path launched:
  1. device  card name, count and power limit (`nvidia-smi`)
  2. build   nvcc build of impg_tpu_torch/csrc (time, registers, spills)
  3. kernels each CUDA kernel against its plain-torch twin on the card,
             exact equality, times from CUDA events in turns, beside its
             bound (bytes over 3.35 TB/s or 32-bit operations over 67 T/s,
             from this run's data) and, where one exists, the one PyTorch
             call that computes its function: K-A over the engine's
             segmented layout (whose build goes in `[setup]`) on 4096
             regions and on 65,536 1 kb regions tiled over the targets plus
             degenerate queries (`stab_count/4096`, `/65536`, each also
             against the segmented count's plain version, beside two
             torch.searchsorted), on malformed records through the window
             route (`/window_route`) and on 2^24 + 2^12 regions
             (`/past_cap`); K-B/K-C/K-D on one chunk of the depth-2
             frontier of the slice below
  4. slice   256 seeds of 10-50 kb, transitive BFS to depth 2 through
             TorchDeviceEngine on a yeast-fitted synthetic index of 250,000
             alignments, then the seeds' region depth (`stats` path) through
             the same engine; rows equal (as sorted multisets per walk) to
             the native C++ engine's, depths equal to the index's stab
     profile one more warm BFS under cProfile and torch.profiler: host
             frames against device time, and the device's idle share
  3. kernels K-E project_approx against its twin on the first lane chunk
             of the approximate depth-2 frontier, lean and full fields, and
             on two crafted lane sets: windows of one lane (a tile spans 512
             queries) and one query owning the chunk
  4. approx  the same seeds, depth 2, approximate (tracepoint) walks
             through TorchDeviceEngine(with_tracepoints=True) (K-B, K-E,
             K-D; no CIGAR arena uploaded); rows equal to the native
             engine's approximate rows
  3. kernels K-C and K-D over one page of the paged engine against their
             twins
  4. paged   the same seeds, depth 2, exact, then their region depth,
             through TorchPagedEngine under a budget of a third of the lean
             index bytes (>= 8 pages, LRU evictions); rows equal to the
             native engine's, depths to the index's stab
  3. kernels K-F syncmer_scan on one 1 Mb haplotype, on the 90-haplotype
             panel in one piece and on a 1 Mb sequence of homopolymers,
             tandem repeats and N runs, K-G map_pack on 256 reads and on a
             65,536-read batch against the panel's universe (flat rows, a
             255 after each sequence), K-H diploid at bench.py's genotype_e2e
             shape (4096 x 131,072 uint8, top_n 10) and at that shape with
             each candidate row twice (exact score ties) beside torch.topk,
             then on tests/test_torch_genotype.py's small cases and on kk
             past the block buffer (the keep-every-key route), all bit-equal
             to the twin, with the cuBLAS products, the panel upload and the
             host float64 run_diploid_topk on their own line
  4. genotype a 90-haplotype panel of a 1 Mb locus (impg_tpu_torch/synth.py)
             and two samples of 200,000 150 bp reads: `syng` through K-F
             (index equal to the native build's, one piece: a scan and a
             write launch), `map` through
             K-G (packs equal to host map_reads, one launch a 65,536-read
             batch: 8), `genotype cos` of the cohort through the Gram and
             K-H (ranks equal to the host's, truth pair first)
     genotype profile  one more warm map and genotype under cProfile and
             torch.profiler
  3. kernels K-I path_sgd: one epoch of the sort graph's layout through the
             kernel and through its twin, both on the card, from the same
             shuffled start: draw mismatches (0), the kernel's moves within
             1e-4 of the twin's largest move and its positions within 1e-4
             of the span (both sum the moves in the same fixed point; the
             span also from the path positions), times, bound; then 30
             epochs of each, their moves held the same way and their
             positions' Spearman rho (>= 0.999)
  4. sort    `sort_pipeline(text, "Ygs", sgd_backend="device")` on a
             90-haplotype variation graph of a 1 Mb locus
             (synth.variation_graph): seconds per stage, K-I launches, peak
             device memory, all 90 spellings unchanged, segments 1..N in a
             topological order, the layout's Spearman rho against path 0;
             then one epoch of the host numpy loop on the same graph
  5. cli     impg_tpu_torch.cli's query -x -o bed|paf, stats -b, query -x
             --approximate -o bed, and query -x -o bed and stats -b under
             IMPG_HBM_BUDGET_BYTES=16384 (paged): --compute-engine device,
             run in this process with its launches counted, byte-identical
             to host (`python -m impg_tpu_torch.cli` in a subprocess), each
             through the expected engine and kernels; then syng and map -o
             pack-tsv byte-identical, and genotype cos over a cohort of two
             packs equal in genotype and rank, through K-F, K-G and K-H;
             `sort --sgd-backend device` (through K-I) and `numpy` (the
             library's bytes) keep the spellings, `--pipeline Q` exits 2
The last two lines are the kernel table and the result as JSON.  Imports
only impg_tpu_torch and, for phase 5's demo data, examples/ (which reaches
tests/datagen.py and tests/pyref.py): an import guard installed before the
port is imported refuses `jax` and `impg_tpu` (and their submodules) and the
run fails if anything tried to import them.  The port's native host library
(its own g++ build) must load, so that the run measures the native visited
bookkeeping.
"""

from __future__ import annotations

import contextlib
import cProfile
import dataclasses
import importlib.util
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BLOCK_COLUMNS = ("q_id", "q_first", "q_last", "t_id", "t_first", "t_last")
SEQ_LEN = 150_000
N_SEQS = 2000
# bench.py's scale tier has 2,500,000 alignments; a tenth of them keeps the
# arena inside DeviceIndex's int32 ceiling (2^31 runs) and the generation
# time inside the run's limit.
N_ALN = 250_000
N_SEEDS = 256
# The paged phase's budget: this share of the index's lean bytes.
PAGED_SHARE = 3
DEVICE = torch.device("cuda", 0)
# The card's peaks for the bound (H100 SXM datasheet, at 700 W): HBM bytes
# per second, and 32-bit scalar operations per second.  The datasheet gives
# no 32-bit integer rate; its float32 rate outside the tensor cores (an FMA
# counted as two operations) stands for it.  Hopper issues integer
# operations at no more than that rate, so a bound by operations errs low.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Integer ops per (record, query) pair of the brute-force count (the first
# K-A's bound, kept beside the segmented count's): three compares and an
# add.
STAB_OPS_PER_PAIR = 4
# Degenerate queries added to K-A's tiled regions.
STAB_DEGENERATE = 256
# The [4 genotype] path: a panel of N_HAPS haplotypes of a LOCUS_LEN locus
# (the scale of one cosigt locus over an HPRC-release-1-sized panel) and two
# samples of N_READS reads of READ_LEN bp (30x of the locus), each from the
# two panel haplotypes named here (founders differ by hap % 6).
N_HAPS = 90
LOCUS_LEN = 1_000_000
N_READS = 200_000
# map_reads_batched's default batch: each sample's N_READS reads are
# ceil(N_READS / READS_PER_BATCH) K-G launches (150 bp reads never reach its
# 16 MiB cap).
READS_PER_BATCH = 65_536
READ_LEN = 150
GT_SAMPLES = {"het": ("hap3", "hap40"), "hom": ("hap25", "hap25")}
# The [4 sort] graph: the same locus size and panel as [4 genotype], as a
# variation graph (about 196k segments, 11.9M path steps).
SORT_HAPS = 90
SORT_LOCUS = 1_000_000
# Operations per sample of K-I that the function itself needs, in 32-bit
# operations: the Philox4x32-10 draw (about 100: per round two 32 x 32
# multiplies, each a high and a low word, and four xors; the key bumps), the
# mapping's integer work (about 12: the index's multiply-high, the offset's
# bits, the sign, two clips), the float64 offset (about 25 operations:
# convert, scale, exp, ceil, convert; counted twice, at half the 32-bit
# rate), the pull (about 20: subtracts, abs, max, reciprocal, min, compare,
# divide, multiplies) and the four accumulations.
PATH_SGD_OPS_PER_SAMPLE = 100 + 12 + 2 * 25 + 20 + 4
# K-I's check starts from the sort graph's first-seen positions dealt to the
# segments in this seed's random order, so that the layout has real moves
# to make (from the path positions an epoch moves a segment tens of bp, less
# than a gate of 1e-4 of the span); the kernel's moves must match the twin's
# within this share of the twin's largest move (on an H100, with the first
# design's float atomics, the gap was 6.3e-7 of it over one epoch and 30: a
# few float32 ulps of the positions).
PATH_SGD_SHUFFLE_SEED = 11
PATH_SGD_MOVE_TOL = 1e-4
# And one epoch's positions, from either start, within this share of the
# graph's span.
PATH_SGD_SPAN_TOL = 1e-4
# K-H's check at bench.py's genotype_e2e shape.
GT_CANDIDATES = 4096
GT_FEATURES = 131_072
GT_TOP_N = 10


class ImportGuard:
    """Meta-path finder that refuses `jax`, `impg_tpu` and their submodules
    (names matched exactly: impg_tpu_torch passes) and records each try."""

    BLOCKED = ("jax", "impg_tpu")

    def __init__(self):
        self.tried = []

    def blocked(self, name: str) -> bool:
        return any(name == b or name.startswith(b + ".") for b in self.BLOCKED)

    def find_spec(self, name, path=None, target=None):
        if self.blocked(name):
            self.tried.append(name)
            raise ImportError(f"chip_smoke: import of {name} refused")
        return None


def _bind_repo() -> None:
    """Put the checkout first on sys.path."""
    if not os.path.isdir(os.path.join(REPO, "impg_tpu_torch")):
        raise SystemExit("chip_smoke: run from a checkout of the repository")
    sys.path.insert(0, REPO)


def scale_queries(n_seqs: int, n: int, seq_len: int = SEQ_LEN):
    """Seeds as bench.py's scale tier draws them: 10-50 kb, numpy seed 7."""
    qr = np.random.default_rng(7)
    targets = []
    for _ in range(n):
        tid = int(qr.integers(n_seqs))
        span = int(qr.integers(10_000, 50_000))
        s = int(qr.integers(0, seq_len - span))
        targets.append((tid, s, s + span))
    return targets


class Recorder:
    """Engine proxy that keeps each batch handed to query_batch_stream and
    the host seconds spent inside the engine's stream (device work, syncs
    and copies included; the caller's bookkeeping excluded)."""

    def __init__(self, engine):
        self.engine = engine
        self.batches = []
        self.engine_s = 0.0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def query_batch_stream(self, q_tid, q_s, q_e, **kw):
        self.batches.append(
            tuple(np.array(a, np.int32) for a in (q_tid, q_s, q_e))
        )
        it = self.engine.query_batch_stream(q_tid, q_s, q_e, **kw)
        while True:
            t0 = time.perf_counter()
            out = next(it, None)
            self.engine_s += time.perf_counter() - t0
            if out is None:
                return
            yield out


def cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_turns(fns: dict, reps: int = 5, rounds: int = 4,
               reps_of: dict | None = None) -> dict:
    """Warm each function, then `rounds` rounds in turns, the order reversed
    every other round (plain, kernel, kernel, plain, ...), `reps` calls a
    turn (`reps_of[name]` where given); median ms per call of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acc = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            acc[k].append(cuda_ms(fns[k], (reps_of or {}).get(k, reps)))
    return {k: float(np.median(v)) for k, v in acc.items()}


def time_pair(kernel_fn, plain_fn, reps: int = 5, rounds: int = 3,
              plain_reps: int | None = None):
    """(kernel ms, plain ms) from `time_turns`; `plain_reps` calls a turn of
    a slow plain twin where given."""
    t = time_turns(dict(plain=plain_fn, kernel=kernel_fn), reps, rounds,
                   None if plain_reps is None else dict(plain=plain_reps))
    return t["kernel"], t["plain"]


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of `fn` (which must not synchronise): the stream
    is first held busy (torch.cuda._sleep) while the host enqueues the
    start event, `reps` calls and the end event, so the events time the
    calls' device work back to back, without the host work between them
    that CUDA events around whole calls also count."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(5_000_000)  # ~3 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the 32-bit rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / OPS_PER_S * 1e3
    return dict(bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def print_kernel_rows(rows: dict) -> None:
    for name, r in rows.items():
        lib = r.get("library_ms")
        extra = f" device_ms={r['device_ms']:.4f}" if "device_ms" in r else ""
        if "device_split_ms" in r:
            extra += f" device_split_ms={json.dumps(r['device_split_ms'])}"
        print(f"[3 kernels] {name} {r['shape']}: tolerance=0 (integers) "
              f"max_abs_err={r['max_abs_err']}"
              f" kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}"
              f" library_ms={'none' if lib is None else f'{lib:.4f}'}"
              f"{extra} bound_ms={r['bound_ms']:.4f} bound_by={r['bound_by']}",
              flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with plain twin")


def lane_census(D, largs, lkw, approximate: bool) -> int:
    """Lanes of a chunk that a lane kernel projects: those passing the hit
    gate with a non-empty range and, for K-C, an overlap with a record that
    has runs (its work list)."""
    d, lane_off, win_lo, q_s, q_e = largs
    q, rec = D._lane_records(lane_off, win_lo, lkw["lane_base"],
                             lkw["n_lanes"])
    ts, te, qs, qe = d.t_start[rec], d.t_end[rec], q_s[q], q_e[q]
    rs, re = ((torch.maximum(qs, ts), torch.minimum(qe, te))
              if lkw["clip_overlap"] else (qs, qe))
    listed = (te >= qs) & (rs < re)
    if not approximate:
        listed &= (rs < te) & (re > ts) & (d.op_cnt[rec] > 0)
    return int(listed.sum())


def check_lanes(D, project, project_plain, largs, lkw, *,
                approximate: bool) -> tuple:
    """A lane kernel (K-C or K-E) against its twin on the same lanes: the
    valid bytes everywhere, the rows on the valid lanes.  Returns the
    kernel's (valid, rows) and its table row.  Bytes of the bound, each read
    or written once: per lane its record's t_start, t_end and the valid
    byte; per query its lane offset, window start and range; per projected
    lane its record's other columns and the arena or tracepoint values at
    the answer; per valid lane its rows."""
    valid, lrows = project(*largs, **lkw)
    p_valid, p_rows = project_plain(*largs, **lkw)
    sel = torch.nonzero(p_valid, as_tuple=True)[0]
    err = max(max_abs_err(valid, p_valid),
              max_abs_err(lrows[:, sel], p_rows[:, sel]))
    ms, pms = time_pair(lambda: project(*largs, **lkw),
                        lambda: project_plain(*largs, **lkw))
    dev_ms = device_ms(lambda: project(*largs, **lkw))
    if approximate:
        per_listed = 4 * 4 + 8 * 4 + 4  # tracepoint columns, boundaries, qid
    else:
        # op_cnt, op_off, strand, query_id; cum_t x4, irun x2, runs x2,
        # cum_q x2 at the boundary runs; the six stats prefixes x2.
        per_listed = 16 + 40 + (48 if lkw["mask"] & D._STATS_MASK else 0)
    n_bytes = (lkw["n_lanes"] * 9 + largs[2].shape[0] * 20
               + lane_census(D, largs, lkw, approximate) * per_listed
               + int(sel.numel()) * lrows.shape[0] * 4)
    return valid, lrows, dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        device_ms=dev_ms,
        **bound(n_bytes),
        shape=f"{lkw['n_lanes']} lanes x {lrows.shape[0]} fields",
        valid=int(sel.numel()),
    )


def check_compact(D, valid, lrows) -> dict:
    """K-D against its twin, timed in turns beside the one PyTorch call that
    computes its function (`rows[:, valid.bool()]`, which the port never
    calls); `device_ms` is its launch's device time alone (scratch memset
    and kernel, without the read of n_hits that the wrapper makes)."""
    hits = D.compact(valid, lrows)
    plain = D.compact_plain(valid, lrows)
    err = max_abs_err(hits, plain)
    if max_abs_err(lrows[:, valid.bool()], plain):
        raise AssertionError("compact: the library call disagrees")
    t = time_turns(dict(
        plain=lambda: D.compact_plain(valid, lrows),
        kernel=lambda: D.compact(valid, lrows),
        library=lambda: lrows[:, valid.bool()],
    ), rounds=4)
    n_rows, n_hits = hits.shape
    return dict(
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["library"],
        device_ms=device_ms(lambda: D.compact_launch(valid, lrows)),
        **bound(valid.shape[0] + 2 * n_hits * n_rows * 4),
        shape=f"{valid.shape[0]} lanes -> {n_hits} x {n_rows}",
    )


def random_regions(b: int) -> list:
    """K-A's queries of earlier runs: target ids in [-1, N_SEQS), 10-50 kb
    regions at random starts (numpy seed 11)."""
    rng = np.random.default_rng(11)
    span = rng.integers(10_000, 50_000, b)
    qs = rng.integers(0, SEQ_LEN - span).astype(np.int32)
    return [rng.integers(-1, N_SEQS, b).astype(np.int32), qs,
            (qs + span).astype(np.int32)]


def tiled_regions(b: int, width: int) -> list:
    """`b` regions of `width` bp tiled over the targets in order (a genome-
    wide `stats -b` BED), then STAB_DEGENERATE degenerate queries in four
    equal parts: s > e, s == e, tid = -1 and tid >= N_SEQS (numpy seed
    12)."""
    per = SEQ_LEN // width
    i = np.arange(b)
    tid = (i // per) % N_SEQS
    qs = (i % per) * width
    qe = qs + width
    rng = np.random.default_rng(12)
    n = STAB_DEGENERATE // 4
    d_tid = rng.integers(0, N_SEQS, 4 * n)
    d_s = rng.integers(0, SEQ_LEN, 4 * n)
    d_e = d_s + rng.integers(1, 20_000, 4 * n)
    d_e[:n] = d_s[:n] - rng.integers(1, 5_000, n)  # s > e
    d_e[n:2 * n] = d_s[n:2 * n]  # s == e
    d_tid[2 * n:3 * n] = -1
    d_tid[3 * n:] = N_SEQS + rng.integers(0, 100, n)
    return [np.concatenate([a, b]).astype(np.int32)
            for a, b in ((tid, d_tid), (qs, d_s), (qe, d_e))]


def stab_work(SC, layout, qa) -> tuple:
    """(queries on a target, search probes, window records) of K-A's
    segmented count on these queries: two searches of ceil(log2(n + 1))
    probes in a segment of n records, and for a query of the window route
    (s > e, or a malformed index) the records of its window."""
    n_seg = layout.n_seg
    tid = qa[0].long()
    ok = (tid >= 0) & (tid < n_seg)
    t = tid.clamp(0, max(n_seg - 1, 0))
    offs = layout.tgt_offsets.long()
    seg_n = (offs[t + 1] - offs[t]).double()
    probes = int((torch.ceil(torch.log2(seg_n + 1)) * 2 * ok).sum())
    win = ok & ((qa[1] > qa[2]) | (not layout.wellformed))
    windows = 0
    if bool(win.any()):
        # The window route's plain count with every t_end passing counts
        # each window's records.
        wide = dataclasses.replace(layout, wellformed=False,
                                   t_end=torch.full_like(layout.t_end,
                                                         2**31 - 1))
        windows = int(SC.stab_counts_segmented_plain(
            wide, qa[0][win], qa[1][win], qa[2][win]).long().sum())
    return int(ok.sum()), probes, windows


def check_stab(SC, d, layout, qa) -> dict:
    """K-A (over the engine's segmented layout) against its plain twin, the
    Pallas layout's brute force, and the segmented count's plain version,
    both on the card; timed in turns beside the library call: two
    torch.searchsorted over composite (tid << 32) + (key - INT_MIN) int64
    keys of t_start and of the sorted t_end, then a subtraction, right only
    for well-formed queries (a target in range, s <= e), so timed on
    those, with its keys built outside the timing.  The bound counts the
    function's work: per query its three words and count, per query on a
    target two segment offsets and the probes of two searches, and the
    t_end of every window record; the old brute-force count, N x B x 4
    operations, is kept in the shape."""
    recs = (d.target_id, d.t_start, d.t_end)
    got = SC.stab_counts_segmented(layout, *qa)
    ref = SC.stab_counts_plain(*recs, *qa)
    seg = SC.stab_counts_segmented_plain(layout, *qa)
    err = max(max_abs_err(got, ref), max_abs_err(seg, ref))
    n_seqs = d.tgt_offsets.shape[0] - 1
    well = (qa[0] >= 0) & (qa[0] < n_seqs) & (qa[1] <= qa[2])
    wq = [a[well] for a in qa]
    rec_key = d.target_id.long() << 32
    key_ts = rec_key + (d.t_start.long() + 2**31)
    key_te = rec_key + (layout.te_sorted.long() + 2**31)

    def library():
        q_key = wq[0].long() << 32
        hi = torch.searchsorted(key_ts, q_key + (wq[2].long() + 2**31),
                                right=True)
        return hi - torch.searchsorted(key_te, q_key + (wq[1].long() + 2**31))

    if max_abs_err(library().int(), got[well]):
        raise AssertionError("stab_count: the library call disagrees")
    t = time_turns(dict(
        plain=lambda: SC.stab_counts_plain(*recs, *qa),
        kernel=lambda: SC.stab_counts_segmented(layout, *qa),
        library=library,
    ), reps=10, rounds=4, reps_of=dict(plain=1))
    b = qa[0].shape[0]
    on_target, probes, windows = stab_work(SC, layout, qa)
    brute = bound(0, d.n_records * b * STAB_OPS_PER_PAIR)["bound_ms"]
    return dict(
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["library"],
        device_ms=device_ms(lambda: SC.stab_counts_segmented(layout, *qa)),
        **bound(b * 16 + on_target * 8 + probes * 4 + windows * 4),
        shape=(f"{d.n_records} records x {b} queries ({int(well.sum())} "
               f"well-formed, {probes} probes, {windows} window records; "
               f"brute-force bound {brute:.4f} ms by operations)"),
        hits=int(got.long().sum()),
    )


def check_stab_window_route(SC) -> None:
    """K-A through `stab_counts` over arbitrary records (the layout of
    distinct target ids, `segmented_layout`) where some have ts > te, one
    spans its whole target and some targets are negative: every query takes
    the window route.  Exact against the brute force on the card."""
    rng = np.random.default_rng(13)
    n, b = 200_000, 4096
    tid = rng.integers(-2, 100, n).astype(np.int32)
    ts = rng.integers(0, SEQ_LEN, n).astype(np.int32)
    te = (ts + rng.integers(0, 20_000, n)).astype(np.int32)
    bad = rng.random(n) < 0.2
    te[bad] = ts[bad] - rng.integers(1, 5_000, int(bad.sum()))
    tid[0], ts[0], te[0] = 7, 0, SEQ_LEN
    q_tid = rng.integers(-3, 103, b).astype(np.int32)
    q_s = rng.integers(0, SEQ_LEN, b).astype(np.int32)
    q_e = (q_s + rng.integers(-5_000, 20_000, b)).astype(np.int32)
    args = [torch.from_numpy(a).to(DEVICE) for a in (tid, ts, te, q_tid, q_s,
                                                      q_e)]
    got = SC.stab_counts(*args)
    err = max_abs_err(got, SC.stab_counts_plain(*args))
    print(f"[3 kernels] stab_count/window_route {n} records (20% ts > te, "
          f"targets -2..99) x {b} queries: tolerance=0 (integers) "
          f"max_abs_err={err} hits={int(got.long().sum())}", flush=True)
    if err:
        raise AssertionError("stab_count/window_route: kernel disagrees")


def check_stab_past_cap(SC, layout) -> None:
    """One count of 2^24 + 2^12 regions, past the 65,535 x 256 a call that
    the first K-A refused: equal to the segmented count's plain version on
    the card (the brute force would take hours at this size)."""
    b = (1 << 24) + (1 << 12)
    qa = [torch.from_numpy(a).to(DEVICE) for a in tiled_regions(b, 1000)]
    got = SC.stab_counts_segmented(layout, *qa)
    err = max_abs_err(got, SC.stab_counts_segmented_plain(layout, *qa))
    dms = device_ms(lambda: SC.stab_counts_segmented(layout, *qa), reps=3)
    print(f"[3 kernels] stab_count/past_cap {b} queries "
          f"(> 65535 x 256 = {65535 * 256}): tolerance=0 (integers) "
          f"max_abs_err={err} device_ms={dms:.4f}", flush=True)
    if err:
        raise AssertionError("stab_count/past_cap: kernel disagrees")


def first_chunk(D, d, batch, lane_budget: int):
    """K-B over a frontier batch on index `d`, then the (args, kwargs) of
    its first lane chunk for a lane kernel, with clip_overlap as the
    transitive walk calls it."""
    fq = [torch.from_numpy(a).to(d.device) for a in batch]
    win_lo, k = D.stab_windows(d.tgt_offsets, d.t_start, d.cummax_te, *fq,
                               d.window_iters)
    offs, offs_h = D.lane_offsets(k)
    q0, q1 = next(D.lane_chunks(offs_h, lane_budget))
    largs = (d, offs[q0:q1 + 1], win_lo[q0:q1], fq[1][q0:q1], fq[2][q0:q1])
    lkw = dict(q_base=q0, lane_base=int(offs_h[q0]),
               n_lanes=int(offs_h[q1] - offs_h[q0]), clip_overlap=True)
    return fq, largs, lkw


def check_launches(label: str, launches: dict, path: tuple) -> None:
    """Every kernel of the path launched in its run; no other did."""
    missing = [k for k in path if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: main path never launched {missing}")
    stray = [k for k, n in launches.items() if n and k not in path]
    if stray:
        raise AssertionError(f"{label}: launched kernels off its path {stray}")


def walk_rows_equal(label: str, blocks, ref) -> int:
    """Rows of each walk equal the reference's as sorted multisets; returns
    the row count."""
    if len(ref) != len(blocks):
        raise AssertionError(f"{label}: walk count differs from reference")
    for w, (g, r) in enumerate(zip(blocks, ref)):
        if not np.array_equal(_sorted_rows(g), _sorted_rows(r)):
            raise AssertionError(f"{label}: walk {w} rows differ from native")
    n_rows = sum(len(b) for b in blocks)
    if n_rows <= len(blocks):
        raise AssertionError(f"{label}: no hits beyond the seeds")
    return n_rows


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] {name} count={count} torch={torch.__version__} "
          f"cuda={torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return dict(kind=name, count=count, smi=smi)


def phase_build(kernels) -> None:
    t0 = time.perf_counter()
    path = kernels.build()
    dt = time.perf_counter() - t0
    rep = kernels.ptxas_report()
    regs = " ".join(
        f"{k}:regs={v.get('registers')},spill={v.get('spill_stores', 0)}"
        f"/{v.get('spill_loads', 0)}" for k, v in sorted(rep.items())
    )
    print(f"[2 build] {dt:.1f}s {os.path.relpath(path, REPO)} {regs}",
          flush=True)


def phase_kernels(eng, index, targets, D, SC, host):
    """Each kernel vs its plain twin on the card (exact); the BFS run here
    captures the depth-2 frontier and warms the path for phase 4.  Returns
    the table rows and the frontier batch."""
    dev = eng.device
    d = eng.dindex
    rec = Recorder(eng)
    host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=rec, columnar=True
    )
    front = max(rec.batches, key=lambda b: b[0].size)
    rows = {}

    # K-A over the engine's segmented layout: 4096 regions (the shape of
    # earlier runs), then 65,536 1 kb regions tiled over the targets with
    # degenerate queries; the window route over malformed records; a count
    # past the old 65,535 x 256 cap.
    layout = eng.stab_layout()
    torch.cuda.synchronize()
    print(f"[setup] stab layout: t_end sorted within {d.tgt_offsets.shape[0] - 1}"
          f" target segments of {d.n_records} records, built and uploaded in "
          f"{eng.stab_layout_s:.3f}s, wellformed={layout.wellformed}",
          flush=True)
    for label, q in (("4096", random_regions(4096)),
                     ("65536", tiled_regions(65_536, 1000))):
        rows[f"stab_count/{label}"] = check_stab(
            SC, d, layout, [torch.from_numpy(a).to(dev) for a in q])
    print_kernel_rows({k: v for k, v in rows.items()
                       if k.startswith("stab_count/")})
    check_stab_window_route(SC)
    check_stab_past_cap(SC, layout)

    # K-B over the whole depth-2 frontier.
    fq, largs, lkw = first_chunk(D, d, front, eng.lane_budget)
    wargs = (d.tgt_offsets, d.t_start, d.cummax_te, *fq, d.window_iters)
    win_lo, k = D.stab_windows(*wargs)
    p_lo, p_k = D.stab_windows_plain(*wargs)
    err = max(max_abs_err(win_lo, p_lo), max_abs_err(k, p_k))
    # The library call: two torch.searchsorted over composite (tid << 32) |
    # key int64 keys of all records (t_start, cummax_te: both ascending
    # within a target's records), built once outside the timing.
    n_seqs = d.tgt_offsets.shape[0] - 1
    rec_tid = d.target_id.long() << 32
    key_ts = rec_tid | d.t_start.long()
    key_te = rec_tid | d.cummax_te.long()

    def library_windows():
        q_tid = fq[0].long() << 32
        cut = torch.searchsorted(key_ts, q_tid | fq[2].long(), right=True)
        lo = torch.searchsorted(key_te, q_tid | fq[1].long())
        return lo, torch.clamp(cut - lo, min=0)

    l_lo, l_k = library_windows()
    ok = (fq[0] >= 0) & (fq[0] < n_seqs)
    if max_abs_err(torch.where(ok, l_k, 0), k) or max_abs_err(
            torch.where(ok & (k > 0), l_lo, 0), torch.where(k > 0, win_lo, 0)):
        raise AssertionError("windows: the library call disagrees")
    t = time_turns(dict(plain=lambda: D.stab_windows_plain(*wargs),
                        kernel=lambda: D.stab_windows(*wargs),
                        library=library_windows), rounds=4)
    ms, pms = t["kernel"], t["plain"]
    # Bytes: per query its three inputs, two outputs, two target offsets and
    # the values its two searches probe.
    tid = fq[0].long()
    ok = (tid >= 0) & (tid < n_seqs)
    tid = tid.clamp(0, n_seqs - 1)
    seg_n = (d.tgt_offsets[tid + 1] - d.tgt_offsets[tid]).double()
    probes = int((torch.ceil(torch.log2(seg_n + 1)) * 2 * ok).sum())
    rows["windows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=t["library"],
        device_ms=device_ms(lambda: D.stab_windows(*wargs)),
        **bound(front[0].size * 28 + probes * 4),
        shape=f"{front[0].size} queries",
    )

    # K-C and K-D on the frontier's first lane chunk, lean then full fields.
    for label, fields in (("lean", host.LEAN_FIELDS), ("full", None)):
        mask = D.field_mask(D.RESULT_FIELDS if fields is None else fields)
        if mask & D._STATS_MASK:
            eng._ensure_stats()
        valid, lrows, rows[f"project_lanes/{label}"] = check_lanes(
            D, D.project_lanes, D.project_lanes_plain, largs,
            dict(lkw, mask=mask), approximate=False,
        )
        rows[f"compact/{label}"] = check_compact(D, valid, lrows)
    print_kernel_rows({k: v for k, v in rows.items()
                       if not k.startswith("stab_count/")})
    return rows, front


def _sorted_rows(block) -> np.ndarray:
    cols = np.stack(
        [np.asarray(getattr(block, c), np.int64) for c in BLOCK_COLUMNS], 1
    )
    return cols[np.lexsort(cols.T[::-1])]


def phase_slice(eng, index, targets, kernels, D, host, upload_lean_bytes):
    """The main path with the launch counts zeroed around it: the depth-2
    transitive BFS of every seed (`query -x`), then the region depth of the
    seeds' own ranges (`stats -r/-b`), both through the one engine.
    Returns the launch counts and the native engine's exact rows."""
    rec = Recorder(eng)
    q = [np.asarray([t[i] for t in targets], np.int32) for i in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blocks = host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=rec, columnar=True
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    depth = eng.stab_counts(*q)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches("slice", launches,
                   ("stab_count", "windows", "project_lanes", "compact"))
    lanes = []
    d = eng.dindex
    for batch in rec.batches:
        _, k = D.stab_windows(
            d.tgt_offsets, d.t_start, d.cummax_te,
            *(torch.from_numpy(a).to(eng.device) for a in batch),
            d.window_iters,
        )
        lanes.append((batch[0].size, int(k.long().sum())))

    exp = [index.stab(t, s, e).size for t, s, e in targets]
    if not np.array_equal(depth, np.asarray(exp)):
        raise AssertionError("region depth differs from the index's stab")
    t1 = time.perf_counter()
    native = host.query_transitive_bfs_many(
        index, targets, max_depth=2,
        device_engine=host.NativeHostEngine(index), columnar=True,
    )
    native_s = time.perf_counter() - t1
    n_rows = walk_rows_equal("slice", blocks, native)
    print(
        f"[4 slice] seeds={len(targets)} depth=2 rows={n_rows} "
        f"wall_s={dt:.3f} seeds_per_s={len(targets) / dt:.2f} "
        f"in_engine_s={rec.engine_s:.3f} "
        f"native_cpu_s={native_s:.3f} rows_equal_native=True "
        f"region_depth_equal_stab=True "
        f"frontier(queries,lanes)/depth={lanes} "
        f"upload_lean_bytes={upload_lean_bytes} "
        f"resident_bytes={eng.dindex.nbytes()} max_memory_allocated={peak} "
        f"launches={json.dumps(launches)}",
        flush=True,
    )
    return launches, native


def _frame_times(stats: dict, name: str, path: str):
    """(tottime, cumtime) of function `name` defined in a file ending in
    `path`, from pstats' raw table; (0, 0) if it never ran."""
    for (file, _line, fn), (_cc, _nc, tt, ct, _callers) in stats.items():
        if fn == name and file.endswith(path):
            return tt, ct
    return 0.0, 0.0


def profiled(fn):
    """Run `fn` once under cProfile and torch.profiler at once: (wall s,
    pstats' raw table, [(device us, op name)] of device ops with time)."""
    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        prof.enable()
        fn()
        prof.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device events only: a CPU op (aten::copy_) also carries the device
    # time of the kernel or copy it issued, which would count it twice.
    events = [e for e in tp.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    attr = ("self_device_time_total"
            if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev = [(getattr(e, attr), e.key) for e in events if getattr(e, attr) > 0]
    return wall, pstats.Stats(prof).stats, dev


def phase_profile(eng, index, targets, host) -> None:
    """One more warm depth-2 BFS under cProfile and torch.profiler at once:
    the BFS loop's own frame (the ctypes calls into the visited
    bookkeeping are inside it: cProfile cannot see into them), the engine's
    stream, the device's busy time per op and its idle share of the wall."""
    wall, st, dev = profiled(lambda: host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=eng, columnar=True
    ))
    bfs_tt, _ = _frame_times(
        st, "_bfs_many_native",
        os.path.join("impg_tpu_torch", "query", "engine.py"),
    )
    _, stream_ct = _frame_times(
        st, "query_batch_stream",
        os.path.join("impg_tpu_torch", "query", "device.py"),
    )
    host_top = sorted(((v[2], k[2]) for k, v in st.items()), reverse=True)[:5]
    busy_s = sum(us for us, _ in dev) / 1e6
    dev_top = sorted(dev, reverse=True)[:6]
    print(
        f"[4 profile] wall_s={wall:.6f} "
        f"bfs_many_native_tottime_s={bfs_tt:.6f} "
        f"query_batch_stream_cumtime_s={stream_ct:.6f} "
        f"device_busy_ms={busy_s * 1e3:.6f} "
        f"device_idle_share={1 - busy_s / wall:.6f} "
        "host_tottime_s_top5="
        + json.dumps([[n, round(t, 6)] for t, n in host_top])
        + " device_ms_top6="
        + json.dumps([[n, round(us / 1e3, 6)] for us, n in dev_top]),
        flush=True,
    )


def crafted_lanes(D, d) -> dict:
    """K-E's two crafted lane sets over index `d` (numpy seed 14), as
    (args, kwargs) of a lane kernel: "one_lane", 2^20 queries with a
    window of one record each, so a 512-lane tile spans 512 queries and
    overflows the stage of 64 lane offsets (the global search); and
    "one_query", one query whose window is every record, so it owns the
    whole chunk.  Ranges sit on the records so that many lanes are valid."""
    rng = np.random.default_rng(14)
    n = d.n_records
    ts, te = d.t_start.cpu().numpy(), d.t_end.cpu().numpy()
    nq = 1 << 20
    win = rng.integers(0, n, nq)
    q_s = ts[win].astype(np.int64) + rng.integers(-300, 300, nq)
    q_e = q_s + rng.integers(-10, 5_000, nq)
    mid = int(np.median(te))
    sets = {
        "one_lane": (np.ones(nq, np.int64), win, q_s, q_e),
        "one_query": (np.asarray([n]), np.zeros(1), np.asarray([mid]),
                      np.asarray([mid + 20_000])),
    }
    out = {}
    for label, (k, lo, qs, qe) in sets.items():
        offs = np.concatenate([[0], np.cumsum(k)]).astype(np.int64) + 777
        largs = (d, torch.from_numpy(offs).to(DEVICE),
                 *(torch.from_numpy(a.astype(np.int32)).to(DEVICE)
                   for a in (lo, qs, qe)))
        out[label] = (largs, dict(q_base=0, lane_base=int(offs[0]),
                                  n_lanes=int(offs[-1] - offs[0]),
                                  clip_overlap=True))
    return out


def phase_approx(index, targets, kernels, D, host) -> tuple:
    """Approximate (tracepoint) walks: the tracepoint build and upload, K-E
    against its twin on the approximate depth-2 frontier, then the main
    path with the counts zeroed around it, against the native engine's
    approximate rows.  Returns the table rows and the path's counts."""
    t0 = time.perf_counter()
    tp = index.ensure_tracepoints()
    tp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = D.TorchDeviceEngine(index, DEVICE, with_tracepoints=True)
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    # The bytes behind the seven tracepoint columns (column views of two
    # interleaved tensors): must equal the seven columns' own bytes, so no
    # separate copy stays resident.
    tp_bytes = sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in eng.dindex.tp.values()}.values())
    if tp_bytes != sum(t.numel() * t.element_size()
                       for t in eng.dindex.tp.values()):
        raise AssertionError("approx: tracepoint columns hold extra bytes")
    print(f"[setup] tracepoints: spacing={tp.spacing} "
          f"boundaries={tp.q_bound.size} build_s={tp_s:.1f} "
          f"tp_device_bytes={tp_bytes} engine_upload_s={up_s:.2f}",
          flush=True)

    # Warm-up walk; its largest depth batch is the K-E check's frontier.
    rec = Recorder(eng)
    host.query_transitive_bfs_many(index, targets, max_depth=2,
                                   device_engine=rec, columnar=True,
                                   approximate=True)
    front = max(rec.batches, key=lambda b: b[0].size)
    _, largs, lkw = first_chunk(D, eng.dindex, front, eng.lane_budget)
    rows = {}
    for label, fields in (("lean", host.LEAN_FIELDS), ("full", D.RESULT_FIELDS)):
        _, _, rows[f"project_approx/{label}"] = check_lanes(
            D, D.project_approx_lanes, D.project_approx_lanes_plain, largs,
            dict(lkw, mask=D.field_mask(fields)), approximate=True,
        )
    for label, (largs, lkw) in crafted_lanes(D, eng.dindex).items():
        _, _, rows[f"project_approx/{label}"] = check_lanes(
            D, D.project_approx_lanes, D.project_approx_lanes_plain, largs,
            dict(lkw, mask=D.field_mask(host.LEAN_FIELDS)), approximate=True,
        )
    print_kernel_rows(rows)

    rec = Recorder(eng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blocks = host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=rec, columnar=True,
        approximate=True,
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches("approx", launches,
                   ("windows", "project_approx", "compact"))
    if eng.dindex.arena:
        raise AssertionError("approx: the CIGAR arena was uploaded")
    t1 = time.perf_counter()
    native = host.query_transitive_bfs_many(
        index, targets, max_depth=2,
        device_engine=host.NativeHostEngine(index), columnar=True,
        approximate=True,
    )
    native_s = time.perf_counter() - t1
    n_rows = walk_rows_equal("approx", blocks, native)
    print(
        f"[4 approx] seeds={len(targets)} depth=2 rows={n_rows} "
        f"tp_build_s={tp_s:.1f} boundaries={tp.q_bound.size} "
        f"tp_device_bytes={tp_bytes} wall_s={dt:.3f} "
        f"seeds_per_s={len(targets) / dt:.2f} in_engine_s={rec.engine_s:.3f} "
        f"native_cpu_s={native_s:.3f} rows_equal_native=True "
        f"resident_bytes={eng.dindex.nbytes()} "
        f"launches={json.dumps(launches)}",
        flush=True,
    )
    return rows, launches


def phase_paged(index, targets, front, native, kernels, D, host):
    """The paged engine under a third of the lean bytes: K-C and K-D over
    one page against their twins, then the exact main path (`query -x`,
    then `stats -r/-b`) with the counts zeroed around it, against the
    native engine's rows and the index's stab.  Returns the table rows."""
    from impg_tpu_torch.query.paged import TorchPagedEngine

    dev = DEVICE
    lean = index.arena.n_ops * 20 + len(index.records) * 36
    budget = lean // PAGED_SHARE

    # K-C and K-D over the first lane chunk of the first page the exact
    # depth-2 frontier touches, on an engine of its own.
    peng = TorchPagedEngine(index, dev, hbm_budget_bytes=budget)
    ri = peng.rindex
    fq = [torch.from_numpy(a).to(dev) for a in front]
    win_lo, k = D.stab_windows(ri.tgt_offsets, ri.t_start, ri.cummax_te, *fq,
                               ri.window_iters)
    page, _base, _sq, offs, offs_h, lo_rel, p_qs, p_qe = next(
        peng.page_lanes(fq[1], fq[2], win_lo.cpu().numpy(), k.cpu().numpy())
    )
    c0, c1 = next(D.lane_chunks(offs_h, peng.lane_budget))
    largs = (page, offs[c0:c1 + 1], lo_rel[c0:c1], p_qs[c0:c1], p_qe[c0:c1])
    lkw = dict(q_base=c0, lane_base=int(offs_h[c0]),
               n_lanes=int(offs_h[c1] - offs_h[c0]), clip_overlap=True,
               mask=D.field_mask(host.LEAN_FIELDS + ("pair_q",)))
    rows = {}
    valid, lrows, rows["project_lanes/page"] = check_lanes(
        D, D.project_lanes, D.project_lanes_plain, largs, lkw,
        approximate=False,
    )
    rows["compact/page"] = check_compact(D, valid, lrows)
    print_kernel_rows(rows)
    del peng, page, largs, valid, lrows
    torch.cuda.empty_cache()

    eng = TorchPagedEngine(index, dev, hbm_budget_bytes=budget)
    rec = Recorder(eng)
    q = [np.asarray([t[i] for t in targets], np.int32) for i in range(3)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    blocks = host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=rec, columnar=True
    )
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    depth = eng.stab_counts(*q)
    launches = kernels.launch_counts()
    check_launches("paged", launches,
                   ("stab_count", "windows", "project_lanes", "compact"))
    n_rows = walk_rows_equal("paged", blocks, native)
    exp = [index.stab(t, s, e).size for t, s, e in targets]
    if not np.array_equal(depth, np.asarray(exp)):
        raise AssertionError("paged: region depth differs from the index's stab")
    if eng.n_pages < 8 or eng.evictions == 0:
        raise AssertionError(f"paged: {eng.n_pages} pages, {eng.evictions} "
                             "evictions (want >= 8 pages and evictions)")
    if len(eng._pages) * eng.page_bytes_each > eng.budget:
        raise AssertionError("paged: resident pages exceed the budget")
    print(
        f"[4 paged] seeds={len(targets)} depth=2 rows={n_rows} "
        f"lean_bytes={lean} budget={budget} pages={eng.n_pages} "
        f"page_bytes_each={eng.page_bytes_each} uploads={eng.uploads} "
        f"evictions={eng.evictions} h2d_bytes={eng.h2d_bytes} "
        f"page_build_s={eng.page_build_s:.3f} "
        f"stab_layout_s={eng.stab_layout_s:.3f} wall_s={dt:.3f} "
        f"seeds_per_s={len(targets) / dt:.2f} in_engine_s={rec.engine_s:.3f} "
        f"rows_equal_native=True region_depth_equal_stab=True "
        f"launches={json.dumps(launches)}",
        flush=True,
    )
    return rows



# ---- the syng read-to-genotype path (K-F, K-G, K-H) ------------------------

# Operations of the closed-syncmer scan that the function itself needs (not
# a kernel's): per window start, the rolling k-mer pack and reverse
# complement (4), canonical min (1) and mix32 (8) of the new k-mer, an
# amortized sliding minimum (3) and the end test (3); per selected window,
# the id's four mix32 and its compare/select (38).
SCAN_OPS_PER_WINDOW = 19
ID_OPS_PER_SELECTED = 38
# Per scored pair of K-H (upper triangle): two adds, a multiply, a sqrt, a
# multiply, a compare and a divide for the score, one for the key.
DIPLOID_OPS_PER_PAIR = 8
# K-H's small checks: tests/test_torch_genotype.py's (n, d, kk) cases (ties,
# kk past n(n+1)/2, kk = n^2, the top_n = 10 head, n = 1), then kk past
# csrc/diploid.cu's kMaxSelect (blocks keep every key): below n(n+1)/2 and
# at n^2.
DIPLOID_MAX_SELECT = 7168
DIPLOID_SMALL_CASES = ((7, 40, 20), (8, 30, 64), (5, 10, 25), (33, 300, 74),
                       (1, 9, 1), (160, 64, 10_000), (128, 64, 128 * 128))


def scan_bytes_ops(seqs: list, k: int, w: int, n_selected: int = 0,
                   n_universe: int = 0, hits: int = 0) -> dict:
    """Bound of the function K-F (no universe) or K-G computes on `seqs`,
    not of either kernel's own work: the flat row's codes (a separator
    each) read once; K-F's 17 bytes a selected occurrence (pos 8, id 8, fwd
    1); K-G's universe read once and an 8-byte count read and written per
    hit; SCAN_OPS_PER_WINDOW operations for each of the sequences' window
    starts and ID_OPS_PER_SELECTED for each of the `n_selected` selected
    windows."""
    n_codes = sum(len(q) + 1 for q in seqs)
    windows = sum(max(0, len(q) - k - w + 1) for q in seqs)
    if n_universe:
        n_bytes = n_codes + n_universe * 8 + hits * 16 + 8
    else:
        n_bytes = n_codes + n_selected * 17
    return bound(n_bytes, windows * SCAN_OPS_PER_WINDOW
                 + n_selected * ID_OPS_PER_SELECTED)


def repeats_sequence(seed: int, length: int) -> bytes:
    """A random sequence of `length` with 60 stretches of 1-20 kb where the
    scan selects at high rates or never: homopolymers of each base (every
    window selects), tandem repeats of periods 2 to 171, and N runs."""
    rng = np.random.default_rng(seed)
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)].copy()
    for i in range(60):
        n = int(rng.integers(1000, 20_000))
        at = int(rng.integers(0, length - n))
        if i % 3 == 0:
            s[at:at + n] = b"ACGT"[(i // 3) % 4]
        elif i % 3 == 1:
            period = (2, 3, 7, 30, 171)[(i // 3) % 5]
            unit = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, period)]
            s[at:at + n] = np.resize(unit, n)
        else:
            s[at:at + n] = ord("N")
    return s.tobytes()


def check_scan(SD, seqs: list, k: int, w: int, seed: int,
               plain_reps: int = 5) -> dict:
    """K-F over `seqs` laid out flat against its twin (every field, exact),
    timed in turns (`plain_reps` calls a turn of the twin); device ms: its
    scan and write launches alone (into an output of the known size,
    without the read of the total), and each entry point's alone (the scan
    with its tile scan, the write)."""
    starts = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(q) + 1 for q in seqs], out=starts[1:])
    codes = torch.from_numpy(SD.encode_batch(seqs)).to(DEVICE)
    starts = torch.from_numpy(starts).to(DEVICE)
    got = SD.extract_syncmers_batch(codes, starts, k, w, seed)
    ref = SD.extract_syncmers_batch_plain(codes, starts, k, w, seed)
    err = max(max_abs_err(getattr(got, f), getattr(ref, f))
              for f in ("pos", "ids", "fwd", "first"))
    ms, pms = time_pair(
        lambda: SD.extract_syncmers_batch(codes, starts, k, w, seed),
        lambda: SD.extract_syncmers_batch_plain(codes, starts, k, w, seed),
        plain_reps=plain_reps)
    out = SD.Syncmers.empty(got.n, got.n_seqs, DEVICE)
    scanned = SD.syncmer_scan_launch(codes, k, w, seed)

    def scan():
        return SD.syncmer_scan_launch(codes, k, w, seed)

    def write(masks, offsets):
        SD.syncmer_write_launch(codes, starts, k, w, seed, masks, offsets,
                                out)

    return dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        device_ms=device_ms(lambda: write(*scan())),
        device_split_ms=dict(scan=device_ms(scan),
                             write=device_ms(lambda: write(*scanned))),
        **scan_bytes_ops(seqs, k, w, n_selected=got.n),
        shape=f"{len(seqs)} x ~{len(seqs[0])} bp, {got.n} selected",
        selected=got.n,
    )


def check_map_pack(SD, reads: list, universe, k: int, w: int,
                   seed: int) -> dict:
    """K-G over the reads laid out flat against its twin (counts and
    n_matched, exact), timed in turns; device ms: the launch alone."""
    codes = torch.from_numpy(SD.encode_batch(reads)).to(DEVICE)
    uni = torch.from_numpy(universe.view(np.int64)).to(DEVICE)
    directory = torch.from_numpy(SD.bucket_directory(universe)).to(DEVICE)
    u = universe.size

    def run(fn):
        counts = torch.zeros(u, dtype=torch.int64, device=DEVICE)
        matched = torch.zeros(1, dtype=torch.int64, device=DEVICE)
        fn(codes, uni, directory, counts, matched, k, w, seed)
        return counts, matched

    got = run(SD.map_pack)
    ref = run(SD.map_pack_plain)
    err = max(max_abs_err(a, b) for a, b in zip(got, ref))
    ms, pms = time_pair(lambda: run(SD.map_pack),
                        lambda: run(SD.map_pack_plain))
    hits = int(ref[1].item())
    # The flat row scanned as one padded row selects what K-G selects.
    selected = int(SD.syncmer_scan_plain(codes[None], k, w, seed)[0].sum())
    return dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        device_ms=device_ms(lambda: SD.map_pack(
            codes, uni, directory, got[0], got[1], k, w, seed)),
        **scan_bytes_ops(reads, k, w, n_selected=selected, n_universe=u,
                         hits=hits),
        shape=f"{len(reads)} reads x {len(reads[0])} bp vs {u} ids, "
              f"{selected} selected",
        matched=hits,
    )


def phase_syncmer_kernels(SD, panel: list, reads: np.ndarray, universe,
                          k: int, w: int, seed: int) -> dict:
    """K-F on one 1 Mb haplotype, on the whole 90-haplotype panel in one
    launch (the `syng` path's shape) and on a 1 Mb sequence of repeats and
    N runs; K-G on 256 reads and on one 65,536-read batch of the first
    sample (the `map` path's shape) against the panel's universe; each
    against its twin (exact)."""
    seqs = [seq for _, seq in panel]
    rows = {
        "syncmer_scan/haplotype": check_scan(SD, seqs[:1], k, w, seed),
        "syncmer_scan/panel": check_scan(SD, seqs, k, w, seed,
                                         plain_reps=1),
        "syncmer_scan/repeats": check_scan(SD, [repeats_sequence(13, LOCUS_LEN)],
                                           k, w, seed),
        "map_pack/reads": check_map_pack(
            SD, [r.tobytes() for r in reads[:256]], universe, k, w, seed),
        "map_pack/batch": check_map_pack(
            SD, [r.tobytes() for r in reads[:READS_PER_BATCH]], universe, k,
            w, seed),
    }
    print_kernel_rows(rows)
    return rows


def _diploid_case(OD, cands: np.ndarray, sample: np.ndarray, kk: int):
    """The cuBLAS products of `cands` (uint8 [n, d]) and `sample` on the
    card, then K-H and its twin: (products, kernel's result, max_abs_err of
    the four outputs' bits)."""
    c = torch.from_numpy(cands).to(DEVICE)
    s_dev = torch.from_numpy(sample.astype(np.float32)).to(DEVICE)
    proj, gram, snorm = OD.products(c, s_dev)
    got = OD.diploid_topk(proj, gram, snorm, kk)
    ref = OD.diploid_topk_plain(proj, gram, snorm, kk)
    err = max(max_abs_err(a.view(torch.int32) if a.is_floating_point()
                          else a,
                          b.view(torch.int32) if b.is_floating_point()
                          else b)
              for a, b in zip(got, ref))
    return (proj, gram, snorm), got, err


def _diploid_row(OD, prods, kk: int, err: int, shape: str) -> dict:
    """K-H timed in turns against its twin and torch.topk over the masked
    flat scores (its values held equal to the twin's), its device time and
    bound."""
    proj, gram, snorm = prods
    n = proj.shape[0]
    sim, _, _ = OD.diploid_scores_plain(proj, gram, snorm)
    upper = torch.ones(n, n, dtype=torch.bool, device=DEVICE).triu()
    masked = torch.where(upper, sim, float("-inf")).reshape(-1)
    del sim, upper
    lib = torch.topk(masked, kk)
    if not torch.equal(lib.values,
                       OD.diploid_topk_plain(proj, gram, snorm, kk)[0]):
        raise AssertionError(f"diploid {shape}: torch.topk's values differ")
    t = time_turns(dict(
        plain=lambda: OD.diploid_topk_plain(proj, gram, snorm, kk),
        kernel=lambda: OD.diploid_topk(proj, gram, snorm, kk),
        library=lambda: torch.topk(masked, kk),
    ), rounds=4)
    return dict(
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["library"],
        device_ms=device_ms(lambda: OD.diploid_topk(proj, gram, snorm, kk)),
        **bound(n * (n + 1) // 2 * 4 + n * 8 + kk * 16,
                n * (n + 1) // 2 * DIPLOID_OPS_PER_PAIR),
        shape=shape,
    )


def _diploid_small_cases(OD) -> str:
    """K-H bit-equal to its twin on tests/test_torch_genotype.py's small
    cases (the same numpy draws: two equal candidates, so tied scores) and
    on kk past DIPLOID_MAX_SELECT, where blocks keep every key (the second
    route), below and past n(n+1)/2."""
    done = []
    for n, d, kk in DIPLOID_SMALL_CASES:
        rng = np.random.default_rng(n * d)
        c = rng.integers(0, 4, (n, d)).astype(np.uint8)
        if n > 3:
            c[2] = c[1]
        s = c[0].astype(np.float32) + c[n // 2] + rng.integers(0, 2, d)
        _, got, err = _diploid_case(OD, c, s, kk)
        if err:
            raise AssertionError(f"diploid n={n} kk={kk}: kernel differs "
                                 f"from its twin by {err}")
        route = "keep-all" if kk > DIPLOID_MAX_SELECT else "select"
        tail = max(0, kk - n * (n + 1) // 2)
        done.append(f"n={n} d={d} kk={kk} ({route}, -inf tail {tail})")
    return "; ".join(done)


def phase_diploid_kernels(gt_core, OD) -> dict:
    """K-H at bench.py's genotype_e2e shape (4096 candidates x 131,072
    features, uint8 counts 0-3, numpy seed 11, top_n 10): the panel upload,
    the cuBLAS products on their own line, K-H against its twin and against
    torch.topk over the masked flat scores, one warm DiploidPanel.top_k and
    the host float64 run_diploid_topk once, whose ranking it must match.
    Then the same shape with each candidate row present twice (every score
    tied exactly with another, ordered by flat index alone), and the small
    cases, each bit-equal to the twin."""
    n, d, top_n = GT_CANDIDATES, GT_FEATURES, GT_TOP_N
    kk = int(min(n * n, max(4 * top_n, top_n + 64)))
    rng = np.random.default_rng(11)
    cands = rng.integers(0, 4, (n, d), dtype=np.uint8)
    sample = (cands[7].astype(np.float64) + cands[1234 % n]
              + rng.integers(0, 2, d))
    cands64 = cands.astype(np.float64)
    t0 = time.perf_counter()
    panel = gt_core.DiploidPanel(cands64, DEVICE)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    s_dev = torch.from_numpy(sample.astype(np.float32)).to(DEVICE)
    gram_ms = time_turns(dict(gram=lambda: OD.products(panel._c, s_dev)),
                         reps=2, rounds=2)["gram"]
    prods, _, err = _diploid_case(OD, cands, sample, kk)
    row = _diploid_row(OD, prods, kk, err,
                       f"{n}x{n} pairs from {n}x{d} uint8, kk={kk}")
    del prods
    half = cands[: n // 2]
    tied = np.concatenate([half, half])
    tied_sample = (tied[7].astype(np.float64) + tied[n // 3]
                   + rng.integers(0, 2, d))
    prods, got, terr = _diploid_case(OD, tied, tied_sample, kk)
    vals = got[0]
    n_ties = int((vals[1:] == vals[:-1]).sum())
    if n_ties == 0:
        raise AssertionError("diploid ties: the tied panel shows no tie")
    tie_row = _diploid_row(OD, prods, kk, terr,
                           f"{n}x{n} pairs, each row twice, kk={kk}")
    del prods, got, vals, tied
    rows = {"diploid/topk": row, "diploid/ties": tie_row}
    print_kernel_rows(rows)
    small = _diploid_small_cases(OD)
    print(f"[3 kernels] diploid small cases bit-equal to the twin: {small}; "
          f"ties in the tied panel's top {kk}: {n_ties}", flush=True)
    t0 = time.perf_counter()
    dev_res = panel.top_k(sample, top_n)
    panel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_res = gt_core.run_diploid_topk(cands64, sample, top_n, device=False)
    host_s = time.perf_counter() - t0
    # Random counts leave near-ties below the top that float32 may order
    # otherwise than float64: the truth pair must lead both; the rest is
    # reported.
    truth = sorted([7, 1234 % n])
    if dev_res[0].combination != truth or host_res[0].combination != truth:
        raise AssertionError("diploid: the truth pair does not lead")
    agree = sum(a.combination == b.combination
                for a, b in zip(dev_res, host_res))
    host_sim = {tuple(r.combination): r.similarity for r in host_res}
    dsim = max((abs(r.similarity - host_sim[tuple(r.combination)])
                for r in dev_res if tuple(r.combination) in host_sim),
               default=0.0)
    gflop = 2.0 * n * n * d / 1e9
    print(f"[3 kernels] diploid products (cuBLAS FP32, uint8->f32 cast, "
          f"C.s, C.C^T, s.s) {n}x{d}: gram_ms={gram_ms:.4f} "
          f"tflops={gflop / gram_ms:.3f} bound_ms="
          f"{bound(n * d, 2.0 * n * n * d)['bound_ms']:.4f} (operations); "
          f"panel_upload_s={upload_s:.3f} (narrowest dtype "
          f"{panel._c.dtype}); panel_top_k_s={panel_s:.4f}; "
          f"host_f64_run_diploid_topk_s={host_s:.3f}; top1={truth} on "
          f"both; ranks equal to host f64: {agree} of {top_n}, max "
          f"|sim - host sim| {dsim:.3g}",
          flush=True)
    del panel, cands64
    torch.cuda.empty_cache()
    return rows


def genotype_data(tmp: str, synth):
    """The [4 genotype] inputs: a 90-haplotype panel of a 1 Mb locus (FASTA)
    and 200,000 150 bp reads of each sample (FASTQ).  Returns (fasta, panel,
    {sample: (fastq, truth haplotypes, reads)})."""
    t0 = time.perf_counter()
    panel = synth.haplotype_panel(seed=5, n_haps=N_HAPS, length=LOCUS_LEN)
    fasta = os.path.join(tmp, "panel.fa")
    synth.write_fasta(fasta, panel)
    seqs = dict(panel)
    samples = {}
    for i, (name, truth) in enumerate(GT_SAMPLES.items()):
        reads = synth.sample_reads(100 + i, [seqs[h] for h in truth],
                                   N_READS, READ_LEN)
        fq = os.path.join(tmp, f"{name}.fq")
        synth.write_fastq(fq, reads)
        samples[name] = (fq, truth, reads)
    print(f"[setup] genotype data: {N_HAPS} haplotypes x ~{LOCUS_LEN} bp, "
          f"{len(samples)} samples x {N_READS} reads x {READ_LEN} bp, "
          f"generated in {time.perf_counter() - t0:.1f}s", flush=True)
    return fasta, panel, samples


def phase_genotype(fasta, panel, samples, native, native_s, kernels,
                   SyngIndex, SD, gt_mod, pack_mod):
    """The read-to-genotype path with the launch counts zeroed around it:
    `syng` through K-F (index arrays equal to the native build's), `map` of
    both samples through K-G (packs and n_matched equal to host map_reads),
    `genotype cos` of the cohort through the cuBLAS Gram and K-H (genotype
    column and rank equal to the host's, dot equal, similarity within 1e-6;
    the host ranks each sample's truth pair first); K-F's two launches (its
    scan and write entry points) for the build's one piece and one K-G
    launch a read batch.  `native` is the native
    extractor's index of the same FASTA.  Returns the counts and the device
    index."""
    hap0_len = len(panel[0][1])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    idx = SyngIndex.build_from_fasta([fasta], extractor="device",
                                     device=DEVICE)
    build_s = time.perf_counter() - t0
    for col in ("occ_ids", "occ_seq", "occ_pos", "occ_fwd"):
        if not np.array_equal(getattr(idx, col), getattr(native, col)):
            raise AssertionError(f"genotype: device index {col} differs")
    packs, map_dev_s = [], 0.0
    for name, (fq, _truth, _reads) in samples.items():
        t0 = time.perf_counter()
        pk, nr, nm = SD.map_reads_batched(idx, [fq], device=DEVICE)
        map_dev_s += time.perf_counter() - t0
        packs.append((name, pk, nr, nm))
    t0 = time.perf_counter()
    cands, dev_multi = gt_mod.genotype_cos_multi(
        idx, [(nm, pk) for nm, pk, _, _ in packs], "hap0", 0, hap0_len,
        device=True, torch_device=DEVICE)
    torch.cuda.synchronize()
    gt_dev_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    check_launches("genotype", launches,
                   ("syncmer_scan", "map_pack", "diploid"))
    # K-F's scan and write for the whole build, one K-G launch a read batch.
    want = {"syncmer_scan": 2,
            "map_pack": len(samples) * -(-N_READS // READS_PER_BATCH)}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"genotype: launches {launches}, want {want}")

    map_host_s = 0.0
    for (name, pk, nr, nm), (fq, _, _) in zip(packs, samples.values()):
        t0 = time.perf_counter()
        hpk, hnr, hnm = pack_mod.map_reads(native, [fq])
        map_host_s += time.perf_counter() - t0
        if (hnr, hnm) != (nr, nm) or not np.array_equal(hpk.counts,
                                                        pk.counts):
            raise AssertionError(f"genotype: {name} pack differs from host")
    t0 = time.perf_counter()
    _, host_multi = gt_mod.genotype_cos_multi(
        native, [(nm, pk) for nm, pk, _, _ in packs], "hap0", 0, hap0_len,
        device=False)
    gt_host_s = time.perf_counter() - t0
    top = {}
    for (name, dres), (_, hres), (truth) in zip(
            dev_multi, host_multi, (v[1] for v in samples.values())):
        if len(dres) != len(hres) or not dres:
            raise AssertionError(f"genotype: {name} row count differs")
        for r, (a, b) in enumerate(zip(dres, hres)):
            if a.combination != b.combination or a.dot != b.dot \
                    or abs(a.similarity - b.similarity) > 1e-6:
                raise AssertionError(f"genotype: {name} rank {r + 1} differs "
                                     f"({a} vs {b})")
        best = sorted(cands[i].genome for i in hres[0].combination)
        if best != sorted(truth):
            raise AssertionError(f"genotype: host ranks {best} first for "
                                 f"{name}, truth {sorted(truth)}")
        top[name] = "|".join(cands[i].name for i in dres[0].combination)
    n_reads = sum(p[2] for p in packs)
    print(
        f"[4 genotype] haplotypes={N_HAPS} occurrences={idx.occ_ids.size} "
        f"universe={packs[0][1].feature_ids.size} candidates={len(cands)} "
        f"index_build_s native={native_s:.3f} device={build_s:.3f} "
        f"index_equal_native=True reads={n_reads} "
        f"map_reads_per_s device={n_reads / map_dev_s:.1f} "
        f"host={n_reads / map_host_s:.1f} packs_equal_host=True "
        f"genotype_s device={gt_dev_s:.3f} host={gt_host_s:.3f} "
        f"ranks_equal_host=True truth_first={json.dumps(top)} "
        f"launches={json.dumps(launches)}",
        flush=True,
    )
    return launches, idx


def phase_genotype_profile(idx, samples, SD, gt_mod, hap0_len) -> None:
    """One more warm map (first sample) and cohort genotype on the device
    under cProfile and torch.profiler: host frames against device time."""
    fq = next(iter(samples.values()))[0]

    def run():
        pk, _, _ = SD.map_reads_batched(idx, [fq], device=DEVICE)
        gt_mod.genotype_cos_multi(idx, [("s", pk)], "hap0", 0, hap0_len,
                                  device=True, torch_device=DEVICE)

    wall, st, dev = profiled(run)
    busy_s = sum(us for us, _ in dev) / 1e6
    host_top = sorted(((v[2], k[2]) for k, v in st.items()), reverse=True)[:6]
    print(
        f"[4 genotype profile] wall_s={wall:.6f} "
        f"device_busy_ms={busy_s * 1e3:.6f} "
        f"device_idle_share={1 - busy_s / wall:.6f} "
        "host_tottime_s_top6="
        + json.dumps([[n, round(t, 6)] for t, n in host_top])
        + " device_ms_top6="
        + json.dumps([[n, round(us / 1e3, 6)]
                      for us, n in sorted(dev, reverse=True)[:6]]),
        flush=True,
    )


def phase_cli(tmp: str, kernels) -> None:
    # examples/make_data.py imports tests/datagen.py.  tests/ has no
    # __init__.py, so it is bound as the `tests` package by hand: an
    # installed package named `tests` would otherwise shadow it.
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = pkg
    spec = importlib.util.spec_from_file_location(
        "make_data", os.path.join(REPO, "examples", "make_data.py")
    )
    make_data = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_data)
    make_data.main(tmp)

    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.query.paged import TorchPagedEngine

    def on_host(argv):
        r = subprocess.run(
            [sys.executable, "-m", "impg_tpu_torch.cli", *argv,
             "--compute-engine", "host"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600,
        )
        if r.returncode != 0:
            raise RuntimeError(f"cli {argv} rc={r.returncode}: {r.stderr}")
        return r.stdout

    def on_device(argv, env):
        """The CLI in this process, so that its launches are counted;
        returns its stdout, launch counts and the engines it resolved."""
        engines = []
        resolve = tcli.resolve_compute_engine

        def recording(*a, **kw):
            engines.append(resolve(*a, **kw))
            return engines[-1]

        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        tcli.resolve_compute_engine = recording
        out = io.StringIO()
        try:
            kernels.reset_launch_counts()
            with contextlib.redirect_stdout(out):
                rc = tcli.main([*argv, "--compute-engine", "device"],
                               device=DEVICE)
            torch.cuda.synchronize()
            launches = kernels.launch_counts()
        finally:
            tcli.resolve_compute_engine = resolve
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise RuntimeError(f"cli {argv} rc={rc}")
        return out.getvalue(), launches, engines

    paf = os.path.join(tmp, "pan.paf")
    walk = ["query", "-a", paf, "-r", "ref:2000-8000", "-d", "100", "-x"]
    stats = ["stats", "-a", paf, "-b", os.path.join(tmp, "regions.bed")]
    # A third of the demo index's lean bytes (2,718 runs x 20 + 8 records
    # x 36 = 54,648): the resolver pages it.
    paged = {"IMPG_HBM_BUDGET_BYTES": "16384"}
    exact = ("windows", "project_lanes", "compact")
    # label -> (argv, environment of the device run, engine, kernels)
    checks = {
        "query -x -o bed": (walk + ["-o", "bed"], {}, "resident", exact),
        "query -x -o paf": (walk + ["-o", "paf"], {}, "resident", exact),
        "stats -b": (stats, {}, "resident", ("stab_count",)),
        "query -x --approximate -o bed": (
            walk + ["--approximate", "-o", "bed"], {}, "tracepoints",
            ("windows", "project_approx", "compact")),
        "query -x -o bed, paged": (walk + ["-o", "bed"], paged, "paged",
                                   exact),
        "stats -b, paged": (stats, paged, "paged", ("stab_count",)),
    }
    parts = []
    for label, (argv, env, kind, path) in checks.items():
        ref = on_host(argv)
        dev, launches, engines = on_device(argv, env)
        if dev != ref or len(dev.splitlines()) < 2:
            raise AssertionError(f"{label}: device output != host output")
        if len(engines) != 1:
            raise AssertionError(f"{label}: resolved {len(engines)} engines")
        eng = engines[0]
        got = ("paged" if isinstance(eng, TorchPagedEngine) else
               "tracepoints" if eng.supports_approximate else "resident")
        if got != kind:
            raise AssertionError(f"{label}: ran the {got} engine, not {kind}")
        check_launches(f"cli {label}", launches, path)
        pages = f" ({eng.n_pages} pages)" if kind == "paged" else ""
        parts.append(f"{label}: {len(dev.splitlines())} lines identical, "
                     f"{kind} engine{pages}, launches {json.dumps(launches)}")
    parts += cli_syng(tmp, on_host, on_device)
    from impg_tpu_torch import synth

    parts += cli_sort(tmp, kernels, synth)
    print("[5 cli] " + "; ".join(parts), flush=True)


def _read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def cli_syng(tmp: str, on_host, on_device) -> list:
    """`syng` and `map -o pack-tsv` byte-identical device (in this process)
    against host (a subprocess), each through its kernel; then `genotype
    cos` over a cohort of two packs: genotype column equal, dot equal,
    similarity within 1e-6, through K-H."""
    fa, fq = os.path.join(tmp, "pan.fa"), os.path.join(tmp, "reads.fastq")
    idx = {e: os.path.join(tmp, f"pan_{e}") for e in ("host", "device")}
    parts = []

    def both(label, argv_of, path, out_of=None):
        on_host(argv_of("host"))
        dev, launches, _ = on_device(argv_of("device"), {})
        check_launches(f"cli {label}", launches, (path,))
        if out_of is not None:
            a, b = _read(out_of("host")), _read(out_of("device"))
            if a != b or not a:
                raise AssertionError(f"cli {label}: device output != host")
            parts.append(f"{label}: {len(a)} bytes identical, launches "
                         f"{json.dumps(launches)}")
        return dev, launches

    both("syng", lambda e: ["syng", "-f", fa, "-o", idx[e]], "syncmer_scan",
         lambda e: idx[e] + ".syngt")
    tsv = {e: os.path.join(tmp, f"reads_{e}.tsv") for e in idx}
    both("map -o pack-tsv", lambda e: [
        "map", "-a", idx[e] + ".syngt", "-q", fq, "-o", "pack-tsv", "-O",
        tsv[e]], "map_pack", lambda e: tsv[e])
    packs = []
    for stem in ("a", "b"):
        packs.append(os.path.join(tmp, f"{stem}.packt"))
        on_host(["map", "-a", idx["host"] + ".syngt", "-q", fq, "-O",
                 packs[-1]])
    argv = ["genotype", "cos", "-a", idx["host"] + ".syngt", "-p",
            ",".join(packs), "-r", "ref:2000-8000"]
    ref = on_host(argv)
    dev, launches, _ = on_device(argv, {})
    check_launches("cli genotype cos", launches, ("diploid",))
    rows = [[line.split("\t") for line in out.splitlines()[1:]]
            for out in (ref, dev)]
    if len(rows[0]) != len(rows[1]) or len(rows[0]) < 2:
        raise AssertionError("cli genotype cos: row counts differ")
    for h, d in zip(*rows):
        # sample, region, rank, genotype equal; cosine within 1e-6 (printed
        # to 6 places: one unit); dot equal.
        if h[:4] != d[:4] or abs(float(h[4]) - float(d[4])) > 1.0000001e-6 \
                or h[6] != d[6]:
            raise AssertionError(f"cli genotype cos: {h} vs {d}")
    parts.append(f"genotype cos (cohort of 2): {len(rows[0])} rows, "
                 f"genotype and rank equal, launches {json.dumps(launches)}")
    return parts


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman's rho of two vectors without ties (ranks by stable sort)."""
    ra = np.empty(a.size)
    rb = np.empty(b.size)
    ra[np.argsort(a, kind="stable")] = np.arange(a.size)
    rb[np.argsort(b, kind="stable")] = np.arange(b.size)
    return float(np.corrcoef(ra, rb)[0, 1])


def sort_data(synth, gfa_columns, sortgfa):
    """The [4 sort] input: (GFA text, its columns, the layout's inputs
    (step_node wrapped, x0, pstart, pend, eta_max, lam, step_pos))."""
    t0 = time.perf_counter()
    text = synth.variation_graph(seed=5, n_haps=SORT_HAPS,
                                 locus_len=SORT_LOCUS)
    gen_s = time.perf_counter() - t0
    gc = gfa_columns.parse_gfa_columns(text)
    step_node, step_pos, bounds = sortgfa.sgd_inputs(gc)
    setup = sortgfa.sgd_setup(gc.n_segs, step_node, step_pos, bounds)
    print(f"[setup] sort graph: {SORT_HAPS} haplotypes x ~{SORT_LOCUS} bp, "
          f"{gc.n_segs} segments, {step_node.size} steps, "
          f"{gc.link_a.size} links, {len(text)} bytes, generated in "
          f"{gen_s:.1f}s", flush=True)
    return text, gc, (*setup, step_pos)


def _move_gap(xk, xp, start) -> dict:
    """How far the kernel's positions xk stand from the twin's xp, against
    how far the twin moved from `start` (all float32 on the card; differences
    in float64): the largest move and the largest gap, the moves' and gaps'
    L2 norms, and the float32 spacing at the largest position (the scale of
    the rounding that the gate allows for)."""
    xk, xp, start = (v.double() for v in (xk, xp, start))
    move = xp - start
    gap = xk - xp
    top = float(torch.maximum(xp.abs().max(), xk.abs().max()))
    return dict(move=float(move.abs().max()), gap=float(gap.abs().max()),
                move_l2=float(move.norm()), gap_l2=float(gap.norm()),
                ulp=float(np.spacing(np.float32(top))))


def _check_moves(what: str, g: dict) -> None:
    """The kernel's moves equal the twin's within PATH_SGD_MOVE_TOL of the
    twin's largest move (and in L2), a tolerance 16 times the float32
    rounding at least, so that the gate cannot pass on rounding alone."""
    tol = PATH_SGD_MOVE_TOL * g["move"]
    if tol < 16 * g["ulp"]:
        raise AssertionError(f"path_sgd {what}: the twin moved {g['move']} "
                             f"at most; the gate would sit in rounding")
    if g["gap"] > tol or g["gap_l2"] > PATH_SGD_MOVE_TOL * g["move_l2"]:
        raise AssertionError(f"path_sgd {what}: kernel and twin moves differ "
                             f"by {g['gap']} (L2 {g['gap_l2']}) against a "
                             f"largest twin move of {g['move']} (L2 "
                             f"{g['move_l2']})")


def phase_path_sgd_kernels(PS, inputs) -> dict:
    """K-I against its twin on the card, from one start and epoch 0.  The
    start is the graph's first-seen positions dealt to the segments in a
    seeded random order (PATH_SGD_SHUFFLE_SEED), so that the layout has
    real work; from the path positions themselves one epoch moves a segment
    a few bp, which is also run.  Held: the kernel's draws (its `pairs`
    output) against the twin's, 0 mismatches; one epoch's moves, kernel
    against twin, within PATH_SGD_MOVE_TOL of the twin's largest move
    (both sum in the same fixed point), and its positions from either start
    within PATH_SGD_SPAN_TOL of the span; times in turns, the kernel's
    device time, the bound; then 30 epochs of each from the same start,
    their moves held the same way and their positions' Spearman rho
    (>= 0.999), beside the rho of the start against the twin's end (how
    far the order moved)."""
    node, x0, pstart, pend, eta_max, lam, step_pos = inputs
    n, n_steps = x0.size, node.size
    batch = 8 * n_steps
    log_n = float(np.log(n_steps))
    steps = PS.sgd_steps(node, step_pos, pstart, pend, n, DEVICE)
    eta = PS.epoch_eta(eta_max, lam, 0)
    xs = x0[np.random.default_rng(PATH_SGD_SHUFFLE_SEED).permutation(n)]
    x_dev = torch.from_numpy(xs.astype(np.float32)).to(DEVICE)
    acc = x_dev.new_zeros(n, dtype=torch.int64)
    cnt = x_dev.new_zeros(n, dtype=torch.int32)
    fixed = PS.fixed_point(batch, PS.move_bound(x0, step_pos))

    def kernel_epoch(x, pairs=None):
        PS.sgd_epoch(x, steps, acc, cnt, 0, batch, eta, log_n, *fixed,
                     pairs=pairs)

    def plain_epoch(x):
        PS.epoch_plain(x, steps, 0, batch, eta, log_n, *fixed)

    x_path = torch.from_numpy(x0.astype(np.float32)).to(DEVICE)
    xk = x_path.clone()
    kernel_epoch(xk)
    xp = x_path.clone()
    plain_epoch(xp)
    from_path = _move_gap(xk, xp, x_path)
    del x_path
    pairs = torch.empty((batch, 2), dtype=torch.int32, device=DEVICE)
    xk = x_dev.clone()
    kernel_epoch(xk, pairs)
    xp = x_dev.clone()
    plain_epoch(xp)
    torch.cuda.synchronize()
    ps = steps[:, 2].to(torch.int64)
    pe = steps[:, 3].to(torch.int64)
    mismatches = 0
    chunk = 1 << 24
    for first in range(0, batch, chunk):
        i, j = PS.draw_pairs(ps, pe, 0, first, min(chunk, batch - first),
                             log_n)
        got = pairs[first:first + i.shape[0]].to(torch.int64)
        mismatches += int(((got[:, 0] != i) | (got[:, 1] != j)).sum())
    del pairs, ps, pe
    one = _move_gap(xk, xp, x_dev)
    scratch = x_dev.clone()
    ms, pms = time_pair(lambda: kernel_epoch(scratch),
                        lambda: plain_epoch(scratch), reps=2, rounds=2)
    dev_ms = device_ms(lambda: kernel_epoch(scratch), reps=5)
    t0 = time.perf_counter()
    x30 = PS.sgd_epochs(xs, node, step_pos, pstart, pend, 30, batch, eta_max,
                        lam, device=DEVICE)
    k30_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    xt = x_dev.clone()
    for t in range(30):
        PS.epoch_plain(xt, steps, t, batch, PS.epoch_eta(eta_max, lam, t),
                       log_n, *fixed)
    torch.cuda.synchronize()
    p30_s = time.perf_counter() - t0
    thirty = _move_gap(torch.from_numpy(x30).to(DEVICE), xt, x_dev)
    xt_np = xt.cpu().numpy().astype(np.float64)
    rho = _spearman(x30, xt_np)
    rho_start = _spearman(xs, xt_np)
    row = dict(
        max_abs_err=one["gap"], ms=ms, plain_ms=pms, library_ms=None,
        device_ms=dev_ms,
        **bound(16 * n_steps + 16 * n, PATH_SGD_OPS_PER_SAMPLE * batch),
        shape=f"{n_steps} steps x 8 = {batch} samples over {n} segments",
    )

    def moves(g):
        big = max(g["move"], 1e-30)
        big_l2 = max(g["move_l2"], 1e-30)
        return (f"max_move={g['move']:.6g} max_gap={g['gap']:.6g} "
                f"gap_over_move={g['gap'] / big:.3g} "
                f"l2_gap_over_move={g['gap_l2'] / big_l2:.3g} "
                f"ulp={g['ulp']:.6g}")

    span = float(step_pos.max() - step_pos.min())
    print(f"[3 kernels] path_sgd/epoch {row['shape']}: draw_mismatches="
          f"{mismatches}; one epoch from the shuffled start: {moves(one)} "
          f"gap_over_span={one['gap'] / span:.3g} (tolerances "
          f"{PATH_SGD_MOVE_TOL} x max_move and {PATH_SGD_SPAN_TOL} x span "
          f"{span:.1f}); from the path positions: "
          f"{moves(from_path)} gap_over_span={from_path['gap'] / span:.3g}; "
          f"kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms=none "
          f"device_ms={dev_ms:.4f} bound_ms={row['bound_ms']:.4f} "
          f"bound_by={row['bound_by']}; 30 epochs from the shuffled start: "
          f"kernel_s={k30_s:.3f} twin_s={p30_s:.3f} {moves(thirty)} "
          f"spearman_rho={rho:.6f} spearman_start_vs_twin_end="
          f"{rho_start:.6f}", flush=True)
    if mismatches:
        raise AssertionError(f"path_sgd: {mismatches} draws differ")
    _check_moves("one epoch", one)
    if max(one["gap"], from_path["gap"]) > PATH_SGD_SPAN_TOL * span:
        raise AssertionError(f"path_sgd: one epoch's positions differ from "
                             f"the twin's by more than {PATH_SGD_SPAN_TOL} "
                             f"of the span {span}")
    _check_moves("30 epochs", thirty)
    if rho < 0.999:
        raise AssertionError(f"path_sgd: 30-epoch positions' rho {rho} "
                             "< 0.999")
    del steps, x_dev, acc, cnt, xk, xp, scratch, xt
    torch.cuda.empty_cache()
    return {"path_sgd/epoch": row}


def _timed(times: dict, key: str, fn):
    """`fn` wrapped to add its seconds to times[key]."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            times[key] = times.get(key, 0.0) + time.perf_counter() - t0
    return run


def phase_sort(text, gc, inputs, kernels, sortgfa, co, gfa_columns) -> dict:
    """`sort_pipeline(text, "Ygs", sgd_backend="device")` with the launch
    counts zeroed around it and each stage timed (module functions wrapped
    for the run): parse, Y (the layout, on the card; then the segment
    reorder), g, s, write.  Then: every path spells what it spelled,
    segments are 1..N in a topological order of the links, the Spearman rho
    of segment rank against path 0's step order, and one epoch of the host
    numpy loop on the same graph.  Returns the launch counts."""
    node, _x0, _ps, _pe, _eta, _lam, step_pos = inputs
    before = co.path_spellings(gc)
    times: dict = {}
    patched = [(gfa_columns, "parse_gfa_columns", "parse"),
               (sortgfa, "sgd_order_columns", "Y_layout"),
               (co, "reorder_segments_columns", "Y_reorder"),
               (co, "groom_columns", "g"),
               (co, "topo_priority_columns", "s"),
               (co, "write_columns", "write")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    try:
        for mod, name, key in patched:
            setattr(mod, name, _timed(times, key, getattr(mod, name)))
        t0 = time.perf_counter()
        out = sortgfa.sort_pipeline(text, "Ygs", sgd_backend="device",
                                    device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches("sort", launches, ("path_sgd",))
    got = gfa_columns.parse_gfa_columns(out)
    after = co.path_spellings(got)
    if after != before or len(after) != SORT_HAPS:
        raise AssertionError("sort: path spellings changed")
    names = [got.names[i] for i in got.seg_name_idx.tolist()]
    if names != [str(k + 1) for k in range(gc.n_segs)]:
        raise AssertionError("sort: segments are not renumbered 1..N")
    rank = np.asarray([int(x) for x in got.names], np.int64)
    if not (rank[got.link_a] < rank[got.link_b]).all():
        raise AssertionError("sort: a link points backwards after 's'")
    walk = rank[got.step_name_idx[got.path_off[0]:got.path_off[1]]]
    rho = _spearman(walk.astype(np.float64),
                    np.arange(walk.size, dtype=np.float64))
    n_steps = node.size
    t0 = time.perf_counter()
    step_node, step_pos_c, bounds = sortgfa.sgd_inputs(gc)
    sortgfa._sgd_order_core(gc.n_segs, step_node, step_pos_c, bounds,
                            epochs=1, backend="numpy")
    host_epoch_s = time.perf_counter() - t0
    print(f"[4 sort] segments={gc.n_segs} steps={n_steps} "
          f"samples_per_epoch={8 * n_steps} epochs=30 wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in times.items())
          + f" launches={json.dumps(launches)} max_memory_allocated="
          f"{peak} spellings_equal={len(after)}/{SORT_HAPS} "
          f"renumbered_1_to_N_topological=True "
          f"spearman_rank_vs_path0={rho:.6f} "
          f"host_numpy_one_epoch_s={host_epoch_s:.3f} "
          f"(extrapolated, not run: 30 epochs "
          f"{30 * host_epoch_s:.1f}s)", flush=True)
    return launches


def cli_sort(tmp: str, kernels, synth) -> list:
    """`sort` on a small variation graph: `--sgd-backend device` in this
    process (through K-I, spellings kept), `--sgd-backend numpy` in a
    subprocess (the library's bytes, spellings kept), `--pipeline Q` exits
    2."""
    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.graph import columnar_ops as co
    from impg_tpu_torch.graph import sortgfa
    from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

    text = synth.variation_graph(seed=2, n_haps=8, locus_len=50_000)
    path = os.path.join(tmp, "locus.gfa")
    with open(path, "w") as fh:
        fh.write(text)
    want = co.path_spellings(parse_gfa_columns(text))

    def cli(*argv):
        return subprocess.run(
            [sys.executable, "-m", "impg_tpu_torch.cli", "sort", path, *argv],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600,
        )

    out = os.path.join(tmp, "locus_device.gfa")
    kernels.reset_launch_counts()
    rc = tcli.main(["sort", path, "--sgd-backend", "device", "--output",
                    out], device=DEVICE)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"cli sort --sgd-backend device rc={rc}")
    check_launches("cli sort", launches, ("path_sgd",))
    if co.path_spellings(parse_gfa_columns(_read(out).decode())) != want:
        raise AssertionError("cli sort device: spellings changed")
    r = cli("--sgd-backend", "numpy")
    if r.returncode != 0:
        raise RuntimeError(f"cli sort numpy rc={r.returncode}: {r.stderr}")
    if r.stdout != sortgfa.sort_pipeline(text, "Ygs", "numpy"):
        raise AssertionError("cli sort numpy: bytes differ from the library")
    if co.path_spellings(parse_gfa_columns(r.stdout)) != want:
        raise AssertionError("cli sort numpy: spellings changed")
    q = cli("--pipeline", "Q")
    if q.returncode != 2 or "unsupported sort pipeline step" not in q.stderr:
        raise AssertionError(f"cli sort --pipeline Q rc={q.returncode}")
    return [f"sort --sgd-backend device: {len(want)} spellings kept, "
            f"launches {json.dumps(launches)}; --sgd-backend numpy: "
            f"{len(r.stdout)} bytes equal to the library's, spellings kept; "
            "--pipeline Q exits 2"]


def main() -> int:
    if len(sys.argv) > 1:
        raise SystemExit("chip_smoke: takes no arguments")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    guard = ImportGuard()
    sys.meta_path.insert(0, guard)
    _bind_repo()
    from impg_tpu_torch import host
    from impg_tpu_torch import kernels
    from impg_tpu_torch.io import native
    from impg_tpu_torch.ops import stab_count as SC
    from impg_tpu_torch.query import device as D
    from impg_tpu_torch import synth
    from impg_tpu_torch.commands import genotype as gt_mod
    from impg_tpu_torch.genotype import core as gt_core
    from impg_tpu_torch.ops import diploid as OD
    from impg_tpu_torch.ops import path_sgd as PS
    from impg_tpu_torch.graph import columnar_ops as co
    from impg_tpu_torch.graph import gfa_columns
    from impg_tpu_torch.graph import sortgfa
    from impg_tpu_torch.ops import syncmer_device as SD
    from impg_tpu_torch.syng import pack as pack_mod
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.synth import realistic_directed_index

    t_start = time.perf_counter()
    dev_info = phase_device()
    phase_build(kernels)
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the port's native host library did not load")
    print(f"[setup] native host library "
          f"{os.path.relpath(native._SO_PATH, REPO)} loaded in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    index = realistic_directed_index(
        seed=3, n_seqs=N_SEQS, seq_len=SEQ_LEN, n_aln=N_ALN
    )
    gen_s = time.perf_counter() - t0
    print(f"[setup] index: {len(index.records)} directed records, "
          f"{index.arena.n_ops} arena runs, generated in {gen_s:.1f}s", flush=True)
    print(f"[setup] reduced: n_aln {N_ALN} of bench scale tier's "
          f"2500000 (DeviceIndex int32 ceiling 2^31 runs; generation time)",
          flush=True)
    t0 = time.perf_counter()
    eng = D.TorchDeviceEngine(index, device=DEVICE)
    torch.cuda.synchronize()
    lean_bytes = eng.dindex.nbytes()
    print(f"[setup] upload {lean_bytes} bytes (lean) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    targets = scale_queries(len(index.seq_index), N_SEEDS)

    rows, front = phase_kernels(eng, index, targets, D, SC, host)
    launches, native_rows = phase_slice(eng, index, targets, kernels, D, host,
                                        lean_bytes)
    phase_profile(eng, index, targets, host)
    del eng
    torch.cuda.empty_cache()
    approx_rows, approx_launches = phase_approx(index, targets, kernels, D,
                                                host)
    rows.update(approx_rows)
    launches["project_approx"] = approx_launches["project_approx"]
    torch.cuda.empty_cache()
    rows.update(phase_paged(index, targets, front, native_rows, kernels, D,
                            host))
    del index, native_rows
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        fasta, panel, samples = genotype_data(tmp, synth)
        t0 = time.perf_counter()
        native_syng = SyngIndex.build_from_fasta([fasta])
        native_s = time.perf_counter() - t0
        rows.update(phase_syncmer_kernels(
            SD, panel, samples["het"][2],
            pack_mod.universe_from_index(native_syng), native_syng.k,
            native_syng.w, native_syng.seed))
        rows.update(phase_diploid_kernels(gt_core, OD))
        gt_launches, syng_idx = phase_genotype(
            fasta, panel, samples, native_syng, native_s, kernels, SyngIndex,
            SD, gt_mod, pack_mod)
        for k in ("syncmer_scan", "map_pack", "diploid"):
            launches[k] = gt_launches[k]
        phase_genotype_profile(syng_idx, samples, SD, gt_mod,
                               len(panel[0][1]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    text, gc, sort_inputs = sort_data(synth, gfa_columns, sortgfa)
    rows.update(phase_path_sgd_kernels(PS, sort_inputs))
    launches["path_sgd"] = phase_sort(text, gc, sort_inputs, kernels,
                                      sortgfa, co, gfa_columns)["path_sgd"]
    del text, gc, sort_inputs
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        phase_cli(tmp, kernels)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m, mod in sys.modules.items()
              if guard.blocked(m) and mod is not None]
    if guard.tried or loaded:
        raise AssertionError(f"the port's paths tried to import "
                             f"{sorted(set(guard.tried + loaded))[:5]}")
    print(f"[done] smoke_s={time.perf_counter() - t_start:.1f} "
          "imports_refused=0", flush=True)

    table = [
        ("stab_count", "stab_count/4096", "impg_tpu_torch/csrc/stab_count.cu",
         "impg_tpu/ops/pallas_stab.py:69"),
        ("windows", "windows", "impg_tpu_torch/csrc/windows.cu",
         "impg_tpu/query/device.py:161"),
        ("project_lanes", "project_lanes/lean",
         "impg_tpu_torch/csrc/project_lanes.cu",
         "impg_tpu/query/device.py:512"),
        ("compact", "compact/lean", "impg_tpu_torch/csrc/compact.cu",
         "impg_tpu/query/device.py:209"),
        ("project_approx", "project_approx/lean",
         "impg_tpu_torch/csrc/project_approx.cu",
         "impg_tpu/query/device.py:393"),
        ("syncmer_scan", "syncmer_scan/panel",
         "impg_tpu_torch/csrc/syncmer.cu",
         "impg_tpu/ops/syncmer_jax.py:81"),
        ("map_pack", "map_pack/batch", "impg_tpu_torch/csrc/syncmer.cu",
         "impg_tpu/ops/syncmer_jax.py:138"),
        ("diploid", "diploid/topk", "impg_tpu_torch/csrc/diploid.cu",
         "impg_tpu/genotype/core.py:300"),
        ("path_sgd", "path_sgd/epoch", "impg_tpu_torch/csrc/path_sgd.cu",
         "impg_tpu/graph/sortgfa.py:161"),
    ]
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name],
             max_abs_err=max(r["max_abs_err"] for key, r in rows.items()
                             if key.split("/")[0] == name),
             **{k: rows[key][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")})
        for name, key, src, rep in table
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
