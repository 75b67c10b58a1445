#!/usr/bin/env python3
"""The port's main path at the JAX package's headline tier on one card.

    python3 chip_scale.py [--part exact|approx|all]
    python3 chip_scale.py --n-aln 250000          # a rehearsal on the card
    python3 chip_scale.py --cpu --n-aln 2000      # a rehearsal on the CPU

bench.py's scale tier ("THE HEADLINE TIER"): realistic_directed_index(seed=3,
n_seqs=2000, seq_len=150_000, n_aln=2_500_000), 5.0M directed records and
about 2.6B arena runs, past the resident engine's int32 offsets.
chip_smoke.py walks a tenth of it; this script walks all of it:

  [scale setup]   the card, the host's memory, the index (records, runs,
                  generation s, peak host RSS); fails under 2^31 runs
  [scale route]   `--compute-engine device` pages it (TorchPagedEngine); the
                  resident index and the mesh refuse it
  [scale exact]   the 256 seeds of bench.py's scale-tier draw to depth 2
                  through the paged engine, at the resolver's budget and at
                  a third of the lean bytes (pages evicted): rows equal to
                  the native engine's, in order; pages, uploads, evictions,
                  H2D bytes, page build s, walk s, seeds/s, peak device
                  memory, launches, the card's idle share
  [scale stats]   4,096 tiled 1 kb regions counted by K-A over the paged
                  engine's record columns: equal to the index's stab
  [scale approx]  the tracepoints (build s; boundaries under 2^31), the
                  resident tracepoint engine that the resolver picks (upload
                  s, bytes) and its approximate walk: rows equal to the
                  native engine's, in order
  [scale kernels] K-A, K-B, and K-C and K-D over a page, on the exact part's
                  shapes, and K-E on the approximate part's: each equal to
                  its plain version on the card, timed beside it, its bound
                  and its library call where one exists (chip_smoke.py's
                  checks)

`--part exact` runs setup, route, exact, stats and their kernels, `--part
approx` setup, route, approx and K-E, `--part all` (the default) both on
one index; each call generates the index from its seed.  When the host's
available memory cannot hold the part at 2,500,000 alignments, the script
takes the most it can, at least MIN_N_ALN, and prints the cut on a
`reduced:` line.  `--n-aln N` is a rehearsal at N alignments: an index under
2^31 runs then has its arena moved past 2^31 into sparse files
(synth.shift_arena), so that every offset still passes the int32 ceiling.
`--cpu` runs the rehearsal on the CPU through the plain versions, with no
timing and no launch counts.  Any failed gate raises and exits non-zero.
The last line is one JSON object: ok, the device, and the run's numbers.
It imports neither jax nor impg_tpu (chip_smoke.py's import guard).
"""

from __future__ import annotations

import argparse
import json
import resource
import shutil
import sys
import tempfile
import time
import types

import numpy as np
import torch

import chip_smoke as cs

N_ALN = 2_500_000  # bench.py's SCALE_N_ALN
# The fewest alignments whose index still passes 2^31 runs, at the 1,034.5
# runs an alignment of the query index (258,626,608 runs of 250,000
# alignments; chip_smoke.py's [setup] line).
MIN_N_ALN = 2_100_000
# Arena runs and tracepoint boundaries an alignment at the tier
# (2,599,618,632 and 1,408,964,055 of 2,500,000; 2,287,735,332 and
# 1,239,891,103 of 2,200,000: chip_scale.py's [scale setup] and [scale
# approx] lines, PERF.md).
RUNS_PER_ALN = 1039.8
BOUNDS_PER_ALN = 563.6
# The host bytes a part needs at n alignments, fitted to the tier's chip
# runs on an H100 host (PERF.md).  The generator peaks at 29.3 B a
# run (76.1 GB over 2,599,618,632 runs).  Then the arena holds 20 B a run
# and, for the approximate part, the tracepoints 20 B a boundary (q_bound
# int32, two int64 prefixes).  The part's walks (the device engine's rows,
# the native engine's, their bookkeeping, the interpreter and torch) took
# the peak RSS WALK_BYTES[part] past those at N_ALN, growing with the
# square of the alignments as the rows do (1.82M at 250,000, 167.3M at
# 2,500,000): the exact part 31.85 GB at 2,500,000 (83.84 GB peak), the
# approximate part 19.74 GB at 2,200,000 (90.29 GB peak), 25.49 GB scaled
# to 2,500,000, where its walk passed the host's 96 GiB limit (80.17 GB
# held).  HOST_MARGIN more, for the spread between runs.
GEN_BYTES_PER_RUN = 29.3
WALK_BYTES = {"exact": 31.85e9, "approx": 25.49e9}
HOST_MARGIN = 8 << 30
N_REGIONS = 4096  # [scale stats]: 1 kb regions tiled over the targets
PART_NAMES = ("exact", "approx")
EXACT_PATH = ("windows", "project_lanes", "compact")


def host_memory() -> dict:
    """MemTotal and MemAvailable of /proc/meminfo and, where the process's
    memory cgroup sets a limit, the bytes it still allows (`cgroup_free`);
    `usable`, the least of MemAvailable and that.  In bytes."""
    out = {}
    with open("/proc/meminfo") as fh:
        for line in fh:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) << 10
    for limit, used in (("memory.max", "memory.current"),
                        ("memory/memory.limit_in_bytes",
                         "memory/memory.usage_in_bytes")):
        try:
            with open(f"/sys/fs/cgroup/{limit}") as a, \
                    open(f"/sys/fs/cgroup/{used}") as b:
                cap, cur = a.read().strip(), b.read().strip()
        except OSError:
            continue
        if cap.isdigit():
            out["cgroup_free"] = int(cap) - int(cur)
        break
    out["usable"] = min(out["MemAvailable"],
                        out.get("cgroup_free", out["MemAvailable"]))
    return out


def peak_rss() -> int:
    """The process's peak resident bytes so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10


def host_need(part: str, n_aln: int) -> float:
    """Host bytes `part` needs at `n_aln` alignments (GEN_BYTES_PER_RUN,
    WALK_BYTES)."""
    runs = n_aln * RUNS_PER_ALN
    held = 20 * runs + (20 * n_aln * BOUNDS_PER_ALN if part == "approx"
                        else 0)
    walks = WALK_BYTES[part] * (n_aln / N_ALN) ** 2
    return max(GEN_BYTES_PER_RUN * runs, held + walks) + HOST_MARGIN


def tier_size(parts: tuple, available: int) -> int:
    """Alignments of the tier the host can hold for `parts`: N_ALN, or the
    most, in steps of 10,000, whose `host_need` fits `available` bytes;
    SystemExit under MIN_N_ALN."""
    n = N_ALN
    while n >= MIN_N_ALN and max(host_need(p, n) for p in parts) > available:
        n -= 10_000
    if n < MIN_N_ALN:
        raise SystemExit(f"chip_scale: {available} bytes of host memory "
                         f"hold fewer than {MIN_N_ALN} alignments")
    return n


class Run:
    """The run's device, its clocks and what it prints: on the CPU no
    synchronisation, no peak memory and no launch counts."""

    def __init__(self, cpu: bool):
        self.cpu = cpu
        self.device = torch.device("cpu") if cpu else cs.DEVICE

    def sync(self) -> None:
        if not self.cpu:
            torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if not self.cpu:
            torch.cuda.reset_peak_memory_stats()

    def peak(self):
        return None if self.cpu else torch.cuda.max_memory_allocated()

    def free_cache(self) -> None:
        if not self.cpu:
            torch.cuda.empty_cache()

    def check_launches(self, label: str, launches: dict, path: tuple) -> None:
        if not self.cpu:
            cs.check_launches(label, launches, path)

    def traced(self, fn):
        """(result, wall s, device busy s or None): `fn` once, on the card
        under torch.profiler (device ops only are summed, as chip_smoke's
        [4 profile] does); None when its trace holds no device time."""
        self.sync()
        if self.cpu:
            t0 = time.perf_counter()
            out = fn()
            return out, time.perf_counter() - t0, None
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ops = cs._device_ops(tp)
        return out, wall, (sum(us for us, _ in ops) / 1e6 if ops else None)


class DepthRecorder(cs.Recorder):
    """chip_smoke's Recorder that also keeps each depth's hits and largest
    window (the engines' int32 `n_hits` and `k_needed`)."""

    def __init__(self, engine):
        super().__init__(engine)
        self.hits = []
        self.k_needed = []

    def query_batch_stream(self, q_tid, q_s, q_e, **kw):
        self.hits.append(0)
        self.k_needed.append(0)
        for out in super().query_batch_stream(q_tid, q_s, q_e, **kw):
            self.hits[-1] += int(out["n_hits"])
            self.k_needed[-1] = max(self.k_needed[-1], int(out["k_needed"]))
            yield out

    def depths(self, d) -> list:
        """[queries, lanes, hits, k_needed] a depth, the lanes from K-B's
        windows over index `d` (a TorchDeviceIndex's record columns)."""
        from impg_tpu_torch.query import device as D

        out = []
        for batch, hits, kn in zip(self.batches, self.hits, self.k_needed):
            q = [torch.from_numpy(a).to(d.device) for a in batch]
            _, k = D.stab_windows(d.tgt_offsets, d.t_start, d.cummax_te, *q,
                                  d.window_iters)
            out.append([int(batch[0].size), int(k.long().sum()), hits, kn])
        return out


def say(phase: str, **info) -> dict:
    print(f"[scale {phase}] " + json.dumps(info), flush=True)
    return info


def walk(host, index, targets, eng, approximate: bool = False):
    return host.query_transitive_bfs_many(
        index, targets, max_depth=2, device_engine=eng, columnar=True,
        approximate=approximate)


def rows_equal_in_order(label: str, blocks, ref) -> int:
    """Each walk's rows equal the reference's, column by column, in order;
    returns the row count."""
    if len(blocks) != len(ref):
        raise AssertionError(f"{label}: walk count differs from native")
    for w, (g, r) in enumerate(zip(blocks, ref)):
        for c in cs.BLOCK_COLUMNS:
            if not np.array_equal(np.asarray(getattr(g, c)),
                                  np.asarray(getattr(r, c))):
                raise AssertionError(f"{label}: walk {w} column {c} differs "
                                     "from native")
    n_rows = sum(len(b) for b in blocks)
    if n_rows <= len(blocks):
        raise AssertionError(f"{label}: no hits beyond the seeds")
    return n_rows


def largest_page_runs(index, eng) -> int:
    run_cum = np.zeros(len(index.records) + 1, np.int64)
    np.cumsum(index.records.op_cnt, out=run_cum[1:])
    return int(np.diff(run_cum[eng.page_edges]).max())


def phase_setup(run: Run, synth, n_aln: int | None, parts: tuple, tmp: str):
    """The index of the tier (or of the rehearsal's n_aln), with its
    numbers; fails under 2^31 runs."""
    mem = host_memory()
    rehearsal = n_aln is not None
    if not rehearsal:
        n_aln = tier_size(parts, mem["usable"])
    t0 = time.perf_counter()
    size = (dict(n_seqs=100, seq_len=60_000) if run.cpu else
            dict(n_seqs=cs.N_SEQS, seq_len=cs.SEQ_LEN))
    index = synth.realistic_directed_index(seed=3, n_aln=n_aln, **size)
    gen_s = time.perf_counter() - t0
    info = dict(n_aln=n_aln, records=len(index.records),
                runs=int(index.arena.n_ops), gen_s=round(gen_s, 1),
                peak_rss=peak_rss(), mem_total=mem["MemTotal"],
                mem_available=mem["MemAvailable"],
                cgroup_free=mem.get("cgroup_free"), **size)
    reduced = []
    if n_aln < N_ALN:
        reduced.append(f"n_aln {n_aln} of bench scale tier's {N_ALN}"
                       + (" (a rehearsal)" if rehearsal else
                          " (the host's usable memory, host_need)"))
    if rehearsal and index.arena.n_ops < 2**31:
        index = synth.shift_arena(index, tmp)
        info["shifted_runs"] = int(index.arena.n_ops)
        reduced.append(f"arena of {info['runs']} runs moved past 2^31 into "
                       "sparse files (synth.shift_arena)")
    if index.arena.n_ops < 2**31:
        raise AssertionError(f"setup: {index.arena.n_ops} runs, under 2^31")
    say("setup", **info)
    for line in reduced:
        print(f"[scale setup] reduced: {line}", flush=True)
    return index, info


def resolve_exact(run: Run, cli, index, TorchPagedEngine):
    """The engine `query --compute-engine device` builds for an exact walk
    of the index: the paged one, at the resolver's budget."""
    args = types.SimpleNamespace(compute_engine="device")
    eng = cli.resolve_compute_engine(args, index, device=run.device)
    if not isinstance(eng, TorchPagedEngine):
        raise AssertionError(f"route: the resolver gave {type(eng).__name__}")
    return eng


def phase_route(run: Run, index, cli, D, sharding, TorchPagedEngine) -> dict:
    """The resolver pages the index; the resident index and the mesh refuse
    it."""
    budget = resolve_exact(run, cli, index, TorchPagedEngine).budget
    refusals = {}
    for name, fn in (("resident", lambda: D.TorchDeviceIndex.build(
            index, run.device)), ("mesh", lambda: sharding.ShardedEngine(
            index, [run.device]))):
        try:
            fn()
        except ValueError as e:
            refusals[name] = str(e)
        else:
            raise AssertionError(f"route: the {name} engine took the index")
    return say("route", engine=TorchPagedEngine.__name__, budget=budget,
               refusals=refusals)


def exact_walk(run: Run, label: str, host, kernels, index, targets, eng,
               native) -> tuple:
    """One traced walk of the tier through paged engine `eng`, held to the
    native rows in order.  Returns its numbers and its Recorder."""
    rec = DepthRecorder(eng)
    run.sync()
    run.reset_peak()
    kernels.reset_launch_counts()
    blocks, wall, busy = run.traced(lambda: walk(host, index, targets, rec))
    launches = kernels.launch_counts()
    peak = run.peak()
    run.check_launches(f"exact {label}", launches, EXACT_PATH)
    n_rows = rows_equal_in_order(f"exact {label}", blocks, native)
    total = None if run.cpu else torch.cuda.get_device_properties(
        run.device).total_memory
    return say(
        "exact", walk=label, rows=n_rows, rows_equal_native_in_order=True,
        budget=eng.budget, pages=eng.n_pages,
        largest_page_runs=largest_page_runs(index, eng),
        page_bytes_each=eng.page_bytes_each, uploads=eng.uploads,
        evictions=eng.evictions, h2d_bytes=eng.h2d_bytes,
        page_build_s=round(eng.page_build_s, 3), wall_s=round(wall, 3),
        seeds_per_s=round(len(targets) / wall, 2),
        in_engine_s=round(rec.engine_s, 3),
        max_memory_allocated=peak, device_total_memory=total,
        launches={k: launches[k] for k in EXACT_PATH},
        depths_queries_lanes_hits_k_needed=rec.depths(eng.rindex),
        device_busy_ms=None if busy is None else round(busy * 1e3, 3),
        device_idle_share=("not measured" if busy is None
                           else round(1 - busy / wall, 6)),
        peak_rss=peak_rss(),
    ), rec


def phase_exact(run: Run, host, kernels, cli, index, targets,
                TorchPagedEngine) -> tuple:
    """[scale exact]: the native rows, then the walk at the resolver's
    budget and at a third of the lean bytes.  Returns the numbers, the
    depth-2 frontier and the evicting engine."""
    t0 = time.perf_counter()
    native = walk(host, index, targets, host.NativeHostEngine(index))
    native_s = time.perf_counter() - t0
    say("exact", walk="native", rows=sum(len(b) for b in native),
        native_cpu_s=round(native_s, 3))
    out = {"native_s": round(native_s, 3)}
    eng = resolve_exact(run, cli, index, TorchPagedEngine)
    out["default"], rec = exact_walk(run, "default budget", host, kernels,
                                     index, targets, eng, native)
    front = max(rec.batches, key=lambda b: b[0].size)
    del eng, rec
    run.free_cache()
    lean = (int(index.records.op_cnt.sum()) * 20
            + len(index.records) * 36)
    small = TorchPagedEngine(index, run.device,
                             hbm_budget_bytes=lean // cs.PAGED_SHARE)
    out["evicting"], _ = exact_walk(run, "a third of the lean bytes", host,
                                    kernels, index, targets, small, native)
    if small.evictions == 0:
        raise AssertionError("exact: no page was evicted under a third of "
                             "the lean bytes")
    out["lean_bytes"] = lean
    return out, front, small


def tiled_queries(n: int) -> list:
    """`n` 1 kb regions tiled over the targets (chip_smoke.tiled_regions
    without its degenerate queries)."""
    return [a[:n] for a in cs.tiled_regions(n, 1000)]


def phase_stats(run: Run, kernels, index, eng) -> dict:
    """[scale stats]: N_REGIONS region counts through K-A over the paged
    engine's record columns, equal to the index's stab."""
    q = tiled_queries(N_REGIONS)
    eng.stab_layout()
    run.sync()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    got = eng.stab_counts(*q)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    run.check_launches("stats", launches, ("stab_count",))
    want = np.asarray([index.stab(t, s, e).size for t, s, e in zip(*q)])
    if not np.array_equal(got, want):
        raise AssertionError("stats: region counts differ from the stab")
    return say("stats", regions=N_REGIONS, hits=int(got.sum()),
               counts_equal_stab=True, call_s=round(wall, 4),
               stab_layout_s=round(eng.stab_layout_s, 3),
               launches=launches["stab_count"])


def phase_exact_kernels(SC, D, host, eng, front) -> dict:
    """K-A over the paged engine's layout (the tiled regions with
    chip_smoke's degenerate ones), K-B over the tier's depth-2 frontier,
    K-C and K-D over the first lane chunk of the first page it touches."""
    dev = cs.DEVICE
    ri = eng.rindex
    rows = {}
    qa = [torch.from_numpy(a).to(dev)
          for a in cs.tiled_regions(N_REGIONS, 1000)]
    rows["stab_count"] = cs.check_stab(SC, ri, eng.stab_layout(), qa)
    step_us = cs.windows_load_latency_us(D)
    rows["windows"] = cs.check_windows(D, ri, front, "tier depth-2 frontier",
                                       step_us)
    fq = [torch.from_numpy(a).to(dev) for a in front]
    win_lo, k = D.stab_windows(ri.tgt_offsets, ri.t_start, ri.cummax_te,
                               *fq, ri.window_iters)
    page, _base, _sq, offs, offs_h, lo_rel, p_qs, p_qe = next(
        eng.page_lanes(fq[1], fq[2], win_lo.cpu().numpy(), k.cpu().numpy()))
    c0, c1 = next(D.lane_chunks(offs_h, eng.lane_budget))
    largs = (page, offs[c0:c1 + 1], lo_rel[c0:c1], p_qs[c0:c1], p_qe[c0:c1])
    lkw = dict(q_base=c0, lane_base=int(offs_h[c0]),
               n_lanes=int(offs_h[c1] - offs_h[c0]), clip_overlap=True,
               mask=D.field_mask(host.LEAN_FIELDS + ("pair_q",)))
    valid, lrows, rows["project_lanes"] = cs.check_lanes(
        D, D.project_lanes, D.project_lanes_plain, largs, lkw,
        approximate=False)
    rows["compact"] = cs.check_compact(D, valid, lrows)
    cs.print_kernel_rows({k: v for k, v in rows.items() if k != "windows"})
    return rows


def phase_approx(run: Run, host, kernels, cli, D, index, targets) -> tuple:
    """[scale approx]: the tracepoints, the engine the resolver picks for an
    approximate walk, and that walk against the native engine's.  Returns
    the numbers, the depth-2 frontier and the engine."""
    t0 = time.perf_counter()
    tp = index.ensure_tracepoints()
    tp_s = time.perf_counter() - t0
    n_bound = int(tp.q_bound.size)
    if n_bound >= 2**31:
        raise AssertionError(f"approx: {n_bound} boundaries pass int32")
    budget = cli.device_budget(run.device)
    need = n_bound * 12 + len(index.records) * 48
    say("approx", tp_build_s=round(tp_s, 1), boundaries=n_bound,
        resident_bytes=need, budget=budget, peak_rss=peak_rss())
    if need > budget:
        raise AssertionError("approx: the tracepoint columns pass the budget "
                             "(the CLI would walk on the host)")
    args = types.SimpleNamespace(compute_engine="device")
    t0 = time.perf_counter()
    eng = cli.resolve_compute_engine(args, index, approximate=True,
                                     device=run.device)
    run.sync()
    up_s = time.perf_counter() - t0
    if not isinstance(eng, D.TorchDeviceEngine) or eng.dindex.arena:
        raise AssertionError("approx: the resolver did not pick the resident "
                             "tracepoint engine")
    rec = DepthRecorder(eng)
    run.reset_peak()
    kernels.reset_launch_counts()
    blocks, wall, busy = run.traced(
        lambda: walk(host, index, targets, rec, approximate=True))
    launches = kernels.launch_counts()
    peak = run.peak()
    rss_walk = peak_rss()
    path = ("windows", "project_approx", "compact")
    run.check_launches("approx", launches, path)
    t0 = time.perf_counter()
    native = walk(host, index, targets, host.NativeHostEngine(index),
                  approximate=True)
    native_s = time.perf_counter() - t0
    n_rows = rows_equal_in_order("approx", blocks, native)
    info = say(
        "approx", rows=n_rows, rows_equal_native_in_order=True,
        engine_upload_s=round(up_s, 2), device_bytes=eng.dindex.nbytes(),
        wall_s=round(wall, 3), seeds_per_s=round(len(targets) / wall, 2),
        in_engine_s=round(rec.engine_s, 3), native_cpu_s=round(native_s, 3),
        max_memory_allocated=peak,
        launches={k: launches[k] for k in path},
        depths_queries_lanes_hits_k_needed=rec.depths(eng.dindex),
        device_busy_ms=None if busy is None else round(busy * 1e3, 3),
        device_idle_share=("not measured" if busy is None
                           else round(1 - busy / wall, 6)),
        peak_rss_device_walk=rss_walk, peak_rss=peak_rss())
    info.update(tp_build_s=round(tp_s, 1), boundaries=n_bound,
                resident_bytes=need, budget=budget)
    return info, max(rec.batches, key=lambda b: b[0].size), eng


def phase_approx_kernels(D, host, eng, front) -> dict:
    """K-E over the first lane chunk of the tier's approximate depth-2
    frontier."""
    _, largs, lkw = cs.first_chunk(D, eng.dindex, front, eng.lane_budget)
    _, _, row = cs.check_lanes(
        D, D.project_approx_lanes, D.project_approx_lanes_plain, largs,
        dict(lkw, mask=D.field_mask(host.LEAN_FIELDS)), approximate=True)
    cs.print_kernel_rows({"project_approx": row})
    return {"project_approx": row}


# Each kernel of the tier's path: (source, the TPU code it replaces), as in
# chip_smoke.py's kernel line.
KERNELS = {
    "stab_count": ("impg_tpu_torch/csrc/stab_count.cu",
                   "impg_tpu/ops/pallas_stab.py:69"),
    "windows": ("impg_tpu_torch/csrc/windows.cu",
                "impg_tpu/query/device.py:161"),
    "project_lanes": ("impg_tpu_torch/csrc/project_lanes.cu",
                      "impg_tpu/query/paged.py:52"),
    "compact": ("impg_tpu_torch/csrc/compact.cu",
                "impg_tpu/query/paged.py:52"),
    "project_approx": ("impg_tpu_torch/csrc/project_approx.cu",
                       "impg_tpu/query/device.py:393"),
}


def kernel_table(rows: dict, launches: dict) -> list:
    return [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=launches.get(name, 0),
                 **{k: rows[name][k] for k in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                     "library_ms", "shape")})
            for name, (src, rep) in KERNELS.items() if name in rows]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("exact", "approx", "all"),
                    default="all")
    ap.add_argument("--n-aln", type=int, default=None,
                    help="a rehearsal at this many alignments")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU (needs --n-aln)")
    args = ap.parse_args(argv)
    if args.cpu and args.n_aln is None:
        raise SystemExit("chip_scale: --cpu rehearses; give --n-aln")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("chip_scale: no CUDA device available")
    parts = PART_NAMES if args.part == "all" else (args.part,)
    guard = cs.ImportGuard()
    sys.meta_path.insert(0, guard)
    cs._bind_repo()
    from impg_tpu_torch import cli, host, kernels, synth
    from impg_tpu_torch.ops import stab_count as SC
    from impg_tpu_torch.parallel import sharding
    from impg_tpu_torch.query import device as D
    from impg_tpu_torch.query.paged import TorchPagedEngine

    t_start = time.perf_counter()
    run = Run(args.cpu)
    if run.cpu:
        dev_info = dict(kind="cpu", count=0, smi="cpu")
    else:
        dev_info = cs.phase_device()
        cs.phase_build(kernels)
    tmp = tempfile.mkdtemp(prefix="chip_scale_")
    result = dict(part=args.part)
    rows, launches = {}, {}
    try:
        index, result["setup"] = phase_setup(run, synth, args.n_aln, parts,
                                             tmp)
        targets = cs.scale_queries(len(index.seq_index), cs.N_SEEDS,
                                   index.seq_index.get_len_from_id(0))
        result["route"] = phase_route(run, index, cli, D, sharding,
                                      TorchPagedEngine)
        run.free_cache()
        if "exact" in parts:
            result["exact"], front, eng = phase_exact(
                run, host, kernels, cli, index, targets, TorchPagedEngine)
            result["stats"] = phase_stats(run, kernels, index, eng)
            for w in ("default", "evicting"):
                for k, n in result["exact"][w]["launches"].items():
                    launches[k] = max(launches.get(k, 0), n)
            launches["stab_count"] = result["stats"]["launches"]
            if not run.cpu:
                rows.update(phase_exact_kernels(SC, D, host, eng, front))
            del eng
            run.free_cache()
        if "approx" in parts:
            result["approx"], front, eng = phase_approx(
                run, host, kernels, cli, D, index, targets)
            launches["project_approx"] = (
                result["approx"]["launches"]["project_approx"])
            if not run.cpu:
                rows.update(phase_approx_kernels(D, host, eng, front))
            del eng
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loaded = [m for m, mod in sys.modules.items()
              if guard.blocked(m) and mod is not None]
    if guard.tried or loaded:
        raise AssertionError(f"imports refused: "
                             f"{sorted(set(guard.tried + loaded))[:5]}")
    result["kernels"] = kernel_table(rows, launches)
    result["scale_s"] = round(time.perf_counter() - t_start, 1)
    print(f"[scale done] scale_s={result['scale_s']} peak_rss={peak_rss()}",
          flush=True)
    print(dev_info["smi"], flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="cpu" if run.cpu else "gpu", kind=dev_info["kind"],
        count=dev_info["count"]), **result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
