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
             from this run's data) and, for K-D, the one PyTorch call that
             computes its function (`rows[:, valid.bool()]`): K-A at the
             index's records x 4096 queries, K-B/K-C/K-D on one chunk of the
             depth-2 frontier of the slice below
  4. slice   256 seeds of 10-50 kb, transitive BFS to depth 2 through
             TorchDeviceEngine on a yeast-fitted synthetic index of 250,000
             alignments, then the seeds' region depth (`stats` path) through
             the same engine; rows equal (as sorted multisets per walk) to
             the native C++ engine's, depths equal to the index's stab
     profile one more warm BFS under cProfile and torch.profiler: host
             frames against device time, and the device's idle share
  3. kernels K-E project_approx against its twin on the first lane chunk
             of the approximate depth-2 frontier, lean and full fields
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
  5. cli     impg_tpu_torch.cli's query -x -o bed|paf, stats -b, query -x
             --approximate -o bed, and query -x -o bed and stats -b under
             IMPG_HBM_BUDGET_BYTES=16384 (paged): --compute-engine device,
             run in this process with its launches counted, byte-identical
             to host (`python -m impg_tpu_torch.cli` in a subprocess), each
             through the expected engine and kernels
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
# per second, and 32-bit scalar operations per second (the
# float32 rate outside the tensor cores, taken for the integer ops here).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
# Integer ops per (record, query) pair of K-A: three compares and an add.
STAB_OPS_PER_PAIR = 4


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


def time_turns(fns: dict, reps: int = 5, rounds: int = 4) -> dict:
    """Warm each function, then `rounds` rounds in turns, the order reversed
    every other round (plain, kernel, kernel, plain, ...); median ms per
    call of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    acc = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            acc[k].append(cuda_ms(fns[k], reps))
    return {k: float(np.median(v)) for k, v in acc.items()}


def time_pair(kernel_fn, plain_fn, reps: int = 5, rounds: int = 3):
    """(kernel ms, plain ms) from `time_turns`."""
    t = time_turns(dict(plain=plain_fn, kernel=kernel_fn), reps, rounds)
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

    # K-A: every record x 4096 region queries.
    rng = np.random.default_rng(11)
    b = 4096
    span = rng.integers(10_000, 50_000, b)
    qs_np = rng.integers(0, SEQ_LEN - span).astype(np.int32)
    qa = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-1, N_SEQS, b).astype(np.int32), qs_np,
        (qs_np + span).astype(np.int32),
    )]
    recs = (d.target_id, d.t_start, d.t_end)
    got = SC.stab_counts(*recs, *qa)
    ref = SC.stab_counts_plain(*recs, *qa)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    ms, pms = time_pair(lambda: SC.stab_counts(*recs, *qa),
                        lambda: SC.stab_counts_plain(*recs, *qa), reps=3)
    rows["stab_count"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
        **bound(d.n_records * 12 + b * 16,
                d.n_records * b * STAB_OPS_PER_PAIR),
        shape=f"{d.n_records}x{b}", hits=int(got.long().sum()),
    )

    # K-B over the whole depth-2 frontier.
    fq, largs, lkw = first_chunk(D, d, front, eng.lane_budget)
    wargs = (d.tgt_offsets, d.t_start, d.cummax_te, *fq, d.window_iters)
    win_lo, k = D.stab_windows(*wargs)
    p_lo, p_k = D.stab_windows_plain(*wargs)
    err = max(max_abs_err(win_lo, p_lo), max_abs_err(k, p_k))
    ms, pms = time_pair(lambda: D.stab_windows(*wargs),
                        lambda: D.stab_windows_plain(*wargs))
    # Bytes: per query its three inputs, two outputs, two target offsets and
    # the values its two searches probe.
    n_seqs = d.tgt_offsets.shape[0] - 1
    tid = fq[0].long()
    ok = (tid >= 0) & (tid < n_seqs)
    tid = tid.clamp(0, n_seqs - 1)
    seg_n = (d.tgt_offsets[tid + 1] - d.tgt_offsets[tid]).double()
    probes = int((torch.ceil(torch.log2(seg_n + 1)) * 2 * ok).sum())
    rows["windows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, library_ms=None,
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
    print_kernel_rows(rows)
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


def phase_profile(eng, index, targets, host) -> None:
    """One more warm depth-2 BFS under cProfile and torch.profiler at once:
    the BFS loop's own frame (the ctypes calls into the visited
    bookkeeping are inside it: cProfile cannot see into them), the engine's
    stream, the device's busy time per op and its idle share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        prof.enable()
        host.query_transitive_bfs_many(
            index, targets, max_depth=2, device_engine=eng, columnar=True
        )
        prof.disable()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = pstats.Stats(prof).stats
    bfs_tt, _ = _frame_times(
        st, "_bfs_many_native",
        os.path.join("impg_tpu_torch", "query", "engine.py"),
    )
    _, stream_ct = _frame_times(
        st, "query_batch_stream",
        os.path.join("impg_tpu_torch", "query", "device.py"),
    )
    host_top = sorted(((v[2], k[2]) for k, v in st.items()), reverse=True)[:5]
    # Device events only: a CPU op (aten::copy_) also carries the device
    # time of the kernel or copy it issued, which would count it twice.
    events = [e for e in tp.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    attr = ("self_device_time_total"
            if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev = [(getattr(e, attr), e.key) for e in events if getattr(e, attr) > 0]
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
    tp_bytes = sum(t.numel() * t.element_size()
                   for t in eng.dindex.tp.values())
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
        f"page_build_s={eng.page_build_s:.3f} wall_s={dt:.3f} "
        f"seeds_per_s={len(targets) / dt:.2f} in_engine_s={rec.engine_s:.3f} "
        f"rows_equal_native=True region_depth_equal_stab=True "
        f"launches={json.dumps(launches)}",
        flush=True,
    )
    return rows


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
    print("[5 cli] " + "; ".join(parts), flush=True)


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
        ("stab_count", "stab_count", "impg_tpu_torch/csrc/stab_count.cu",
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
