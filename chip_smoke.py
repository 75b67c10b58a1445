#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (impg_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each, in order; any failure raises and exits non-zero:
  1. device  card name, count and power limit (`nvidia-smi`)
  2. build   nvcc build of impg_tpu_torch/csrc (time, registers, spills)
  3. kernels each CUDA kernel against its plain-torch twin on the card,
             exact equality, times from CUDA events in alternation: K-A at
             the index's records x 4096 queries, K-B/K-C/K-D on one chunk of
             the depth-2 frontier of the slice below
  4. slice   256 seeds of 10-50 kb, transitive BFS to depth 2 through
             TorchDeviceEngine on a yeast-fitted synthetic index of 250,000
             alignments, then the seeds' region depth (`stats` path) through
             the same engine; rows equal (as sorted multisets per walk) to
             the native C++ engine's, depths equal to the index's stab, and
             every kernel's launch count from that run above zero
     profile one more warm BFS under cProfile and torch.profiler: host
             frames against device time, and the device's idle share
  5. cli     `python -m impg_tpu_torch.cli` query -x -o bed|paf and stats -b,
             --compute-engine device byte-identical to host
The last two lines are the kernel table and the result as JSON.  Imports
only impg_tpu_torch (whose host half is impg_tpu's JAX-free numpy/C++ code,
see impg_tpu_torch/host.py) and, for phase 5's demo data, examples/: the
machine with the card has no JAX.
"""

from __future__ import annotations

import cProfile
import importlib.util
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


def time_pair(kernel_fn, plain_fn, reps: int = 5, rounds: int = 3):
    """Warm, then (plain, kernel, kernel, plain)-style alternation; median
    ms per call of each."""
    kernel_fn()
    plain_fn()
    torch.cuda.synchronize()
    k_ms, p_ms = [], []
    for r in range(rounds):
        order = ((plain_fn, p_ms), (kernel_fn, k_ms))
        for fn, acc in (order if r % 2 == 0 else order[::-1]):
            acc.append(cuda_ms(fn, reps))
    return float(np.median(k_ms)), float(np.median(p_ms))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


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


def phase_kernels(eng, index, targets, kernels, D, SC, host) -> dict:
    """Each kernel vs its plain twin on the card (exact); the BFS run here
    captures the depth-2 frontier and warms the path for phase 4."""
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
    rows["stab_count"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                              shape=f"{d.n_records}x{b}",
                              hits=int(got.long().sum()))

    # K-B over the whole depth-2 frontier.
    fq = [torch.from_numpy(a).to(dev) for a in front]
    wargs = (d.tgt_offsets, d.t_start, d.cummax_te, *fq, d.window_iters)
    win_lo, k = D.stab_windows(*wargs)
    p_lo, p_k = D.stab_windows_plain(*wargs)
    err = max(max_abs_err(win_lo, p_lo), max_abs_err(k, p_k))
    ms, pms = time_pair(lambda: D.stab_windows(*wargs),
                        lambda: D.stab_windows_plain(*wargs))
    rows["windows"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           shape=f"{front[0].size} queries")

    # K-C and K-D on the frontier's first lane chunk, lean then full fields.
    offs = torch.zeros(k.shape[0] + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(k, 0)
    offs_h = offs.cpu().numpy()
    q0, q1 = next(eng._chunks(offs_h))
    n_lanes = int(offs_h[q1] - offs_h[q0])
    for label, fields in (("lean", host.LEAN_FIELDS), ("full", None)):
        mask = D.field_mask(D.RESULT_FIELDS if fields is None else fields)
        if mask & D._STATS_MASK:
            eng._ensure_stats()
        largs = (d, offs[q0:q1 + 1], win_lo[q0:q1], fq[1][q0:q1], fq[2][q0:q1])
        lkw = dict(q_base=q0, lane_base=int(offs_h[q0]), n_lanes=n_lanes,
                   clip_overlap=True, mask=mask)
        valid, lrows = D.project_lanes(*largs, **lkw)
        p_valid, p_rows = D.project_lanes_plain(*largs, **lkw)
        sel = torch.nonzero(p_valid, as_tuple=True)[0]
        err = max(max_abs_err(valid, p_valid),
                  max_abs_err(lrows[:, sel], p_rows[:, sel]))
        ms, pms = time_pair(lambda: D.project_lanes(*largs, **lkw),
                            lambda: D.project_lanes_plain(*largs, **lkw))
        rows[f"project_lanes/{label}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms,
            shape=f"{n_lanes} lanes x {lrows.shape[0]} fields",
            valid=int(sel.numel()),
        )
        hits = D.compact(valid, lrows)
        p_hits = D.compact_plain(valid, lrows)
        err = max_abs_err(hits, p_hits)
        ms, pms = time_pair(lambda: D.compact(valid, lrows),
                            lambda: D.compact_plain(valid, lrows))
        rows[f"compact/{label}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=pms,
            shape=f"{n_lanes} lanes -> {hits.shape[1]} x {hits.shape[0]}",
        )
    for name, r in rows.items():
        print(f"[3 kernels] {name} {r['shape']}: tolerance=0 (integers) "
              f"max_abs_err={r['max_abs_err']}"
              f" kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f}",
              flush=True)
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: kernel disagrees with plain twin")
    return rows


def _sorted_rows(block) -> np.ndarray:
    cols = np.stack(
        [np.asarray(getattr(block, c), np.int64) for c in BLOCK_COLUMNS], 1
    )
    return cols[np.lexsort(cols.T[::-1])]


def phase_slice(eng, index, targets, kernels, D, host,
                upload_lean_bytes) -> dict:
    """The main path with the launch counts zeroed around it: the depth-2
    transitive BFS of every seed (`query -x`), then the region depth of the
    seeds' own ranges (`stats -r/-b`), both through the one engine."""
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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
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
    n_rows = sum(len(b) for b in blocks)
    if len(native) != len(blocks):
        raise AssertionError("walk count differs from the native engine")
    for w, (g, r) in enumerate(zip(blocks, native)):
        if not np.array_equal(_sorted_rows(g), _sorted_rows(r)):
            raise AssertionError(f"walk {w}: rows differ from native engine")
    if n_rows <= len(targets):
        raise AssertionError("slice produced no hits beyond the seeds")
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
    return launches


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
    bfs_tt, _ = _frame_times(st, "_bfs_many_native",
                             os.path.join("impg_tpu", "query", "engine.py"))
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


def phase_cli(tmp: str) -> None:
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
    env = dict(os.environ, PYTHONPATH=REPO)

    def cli(*argv):
        r = subprocess.run(
            [sys.executable, "-m", "impg_tpu_torch.cli", *argv],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600,
        )
        if r.returncode != 0:
            raise RuntimeError(f"cli {argv} rc={r.returncode}: {r.stderr}")
        return r.stdout

    paf = os.path.join(tmp, "pan.paf")
    checks = {
        "query -x -o bed": ["query", "-a", paf, "-r", "ref:2000-8000", "-d",
                            "100", "-x", "-o", "bed"],
        "query -x -o paf": ["query", "-a", paf, "-r", "ref:2000-8000", "-d",
                            "100", "-x", "-o", "paf"],
        "stats -b": ["stats", "-a", paf, "-b",
                     os.path.join(tmp, "regions.bed")],
    }
    parts = []
    for label, argv in checks.items():
        on_host = cli(*argv, "--compute-engine", "host")
        dev = cli(*argv, "--compute-engine", "device")
        if dev != on_host or len(dev.splitlines()) < 2:
            raise AssertionError(f"{label}: device output != host output")
        parts.append(f"{label}: {len(dev.splitlines())} lines identical")
    print("[5 cli] " + "; ".join(parts), flush=True)


def main() -> int:
    if len(sys.argv) > 1:
        raise SystemExit("chip_smoke: takes no arguments")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    _bind_repo()
    from impg_tpu_torch import host
    from impg_tpu_torch import kernels
    from impg_tpu_torch.ops import stab_count as SC
    from impg_tpu_torch.query import device as D
    from impg_tpu_torch.synth import realistic_directed_index

    dev_info = phase_device()
    phase_build(kernels)

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
    eng = D.TorchDeviceEngine(index, device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    lean_bytes = eng.dindex.nbytes()
    print(f"[setup] upload {lean_bytes} bytes (lean) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    targets = scale_queries(len(index.seq_index), N_SEEDS)

    rows = phase_kernels(eng, index, targets, kernels, D, SC, host)
    launches = phase_slice(eng, index, targets, kernels, D, host,
                           lean_bytes)
    phase_profile(eng, index, targets, host)
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        phase_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

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
    ]
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name],
             max_abs_err=max(r["max_abs_err"] for key, r in rows.items()
                             if key.split("/")[0] == name),
             ms=rows[key]["ms"], plain_ms=rows[key]["plain_ms"])
        for name, key, src, rep in table
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"],
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
