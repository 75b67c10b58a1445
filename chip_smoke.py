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
             (`/past_cap`); K-B (windows and lane offsets in one launch)
             on the depth-2 frontier of the slice below, its call (host
             columns to host offsets), device time, bound and latency floor
             (its search step measured here) beside the plain twin's and the
             library route's (two torch.searchsorted and a cumsum), and
             past 2^32 lanes (`windows/past_2^32`: 2^16 + 3 queries each
             over all of one 2^16-record segment); K-C/K-D on that
             frontier's first lane chunk
  4. slice   256 seeds of 10-50 kb, transitive BFS to depth 2 through
             TorchDeviceEngine on a yeast-fitted synthetic index of 250,000
             alignments, then the seeds' region depth (`stats` path) through
             the same engine; rows equal (as sorted multisets per walk) to
             the native C++ engine's, depths equal to the index's stab
     profile one more warm BFS under cProfile and torch.profiler: host
             frames against device time, and the device's idle share
  4. partition `partition_alignments` of the same index (50 kb windows, one
             transitive walk a window) on the native C++ engine and on
             TorchDeviceEngine: BED bytes equal, the same walks, K-B, K-C
             and K-D launched; K-B at a walk's depth-1 frontier (one query)
             and at the median depth-2 frontier of the partition's walks
             (`[3 kernels] windows`); the first eighth of the walks of
             one more device run under cProfile and torch.profiler
  4. refine  `run_refine` with transitive walks (`refine -x`) over 32 seeds,
             native against the resident engine: records equal
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
             then an eighth of an epoch of the host numpy loop on it
  4. genotype graph  `genotype_graph` on that graph (impg_tpu_torch/
             genotype/graph.py): 25,000 reads of hap3 + hap16 (an eighth
             of a 30x sample's) mapped to the
             90 path walks on the host, the candidates x segments matrix,
             the cuBLAS products and K-H (top 10), seconds per stage, K-H's
             launches equal to its calls, the device's idle share, the head
             equal to the host float64 ranking beyond 1e-6 ties and the
             truth pair's rank reported (impg_tpu's read mapping credits a
             read every path shares to the first path); then from the
             truth pair's exact coverage with every pair ranked (kk 8,100,
             K-H's keep-every-key route): the truth pair first, the ranking
             the host's; K-H against its twin at that kk
             (`[3 kernels] diploid/graph_keep_all`)
  4. sequence  the sequence layer and the POA region outputs through the
             port's CLI in this process on a panel of one 1 Mb locus
             (synth.panel_alignments: base, 6 founders, 90 haplotypes, 96
             exact alignments), walked -x -m 2 -d 0 from base on the card
             (K-B, K-C, K-D launched in every run, nothing else; the card's
             busy time and idle share from torch.profiler; walk, POA and
             writing seconds): `query -o fasta` and `fasta+paf` over 64
             windows of 10 kb, bytes equal to the native and host engines;
             `-o gfa|maf|fasta-aln|vcf` and `similarity --pca` over 4
             windows of 2 kb, every window's walk rows equal to the native
             engine's and the first window's bytes equal to a native run;
             `partition -o fasta` (100 kb windows) and `-o gfa` (on a cut
             panel), every file equal to the native engine's
  4. graph pipeline  the region graph engines and post-processing stages
             through the CLI on the same panels, walked on the card as
             above (the walk, alignment and induction, POA, each stage and
             the rest timed): `-o gfa --gfa-engine pggb` over 2 of those
             2 kb windows and `-o gfa:cut-n=100:sort:sgd:smooth,block-len=
             900:normalize:crush:selfloops` over the first; `--gfa-engine
             seqwish|syng-native`, `-o vcf --gfa-engine seqwish` and `-o
             gfa:sgd --gfa-engine pggb` over 3 windows of the cut panel;
             every window's walk rows equal to the native engine's, the
             first window's output and standard error equal to a native
             run's; then the cut panel's syng index built through K-F
             (equal to the host build) and `.syngt` queries with sequence
             files (`-x -o bed` with refined chain ends, `gfa`, `fasta`,
             `maf`, `fasta-aln`, `vcf`, `gfa:sort`) equal on the
             device-built and the host-built index
  4. tracepoint files  `.1aln` and `.tpa` through the CLI: an index of
             6,000 alignments written with write_1aln (ASCII, binary) and
             write_tpa (fastga, standard), each ingested by `index` without
             sequences and walked on the card (`query -x` of the 256 seeds:
             K-B, K-C, K-D; `--approximate`: K-B, K-E, K-D; `stats -b` of
             K-A's regions: K-A) against the native engine (the host's for
             stats), bytes equal, the ASCII and binary files' indexes equal;
             `export-1aln --binary` and `export-tpa` of the sequence
             panel's first 8 alignments, `query -x -o bed
             --sequence-files` over the 64 windows of 10 kb, device against
             native (rows off the PAF index's counted); `query -x -o gbwt`
             over the 4 windows of 2 kb, device against native, and `-o
             gbwt` of the cut panel's `.syngt`: regional `.syngt` members
             equal
  4. syng tools  on the cut panel's device-built syng index: `syng2gfa`
             blunt, raw and `--gfa-version 1.1` (every blunt path spells its
             sequence), `syng-repair --force` (occurrences unchanged),
             `read-index`, `map -o pack|gaf` on the card (K-G) and on the
             host, and `infer -w 1000 --gaf --read-index
             --write-haplotypes` from each: report and haplotypes equal
  4. graph toolbox  every GFA toolbox command through the port's CLI in
             this process, on the host as in impg_tpu, each line with its
             wall s, input size, the host stages that took most of it, the
             card's busy ms and idle share (torch.profiler) and K-I's
             launches beside pggb's Ygs samples against 5e8: after `[4
             genotype graph]`, `graph-report` of the sort graph (its counts
             equal its columns'), `map --graph -o gaf` of 10,000
             of its reads onto the graph cut to paths hap0-hap3, hap16 and
             `project` of that GAF (every record retained); after `[4 syng tools]`, on `[4 graph pipeline]`'s
             two pggb window graphs `normalize`, `normalize-self-loops`
             (and `--diagnose`), `smooth`, `crush` (each output spelling
             its input's paths), `render-graph`, `gfa2vcf` (anchors,
             flubbles), `graph-report` (md, json, tsv, `--flubbles`;
             report_columns equal to report), `lace --fill-gaps` of the two
             graphs (laced paths spelling the panel between their ends) and
             of their VCFs (the records lifted back exactly); on the cut
             panel `align` (and `--job-list`, `--run-joblist` of its first
             4 jobs in subprocesses, each pair file equal to align's rows),
             `graph` poa (its first 8 sequences), seqwish, pggb, `-a
             align.paf` (equal to seqwish aligning itself) and
             `--partition-size 2000` (every path spelling its input); `agz
             create|list` of the panel (every contig fetched back equal)
             and `query -o fasta` of 16 of the 10 kb windows through the
             archive (K-B, K-C, K-D; bytes equal to the FASTA-backed run);
             `render -x --render-graph` of a 2 kb window, of the panel with
             the poa engine and of the cut panel with pggb (the manifest
             naming every file of the bundle)
  5. cli     impg_tpu_torch.cli's query -x -o bed|paf, stats -b, query -x
             --approximate -o bed, query -x -o bed and stats -b under
             IMPG_HBM_BUDGET_BYTES=16384 (paged), partition -o bed|paf (the
             --output-folder files compared) and refine -x:
             --compute-engine device,
             run in this process with its launches counted, byte-identical
             to host (`python -m impg_tpu_torch.cli` in a subprocess), each
             through the expected engine and kernels; then syng and map -o
             pack-tsv byte-identical, and genotype cos over a cohort of two
             packs equal in genotype and rank, through K-F, K-G and K-H;
             `map -a -o gaf|paf|proj` (proj's pack through K-G) and `query
             -a X.syngt -o bed|bedpe`, raw and -x, byte-identical;
             `sort --sgd-backend device` (through K-I) and `numpy` (the
             library's bytes) keep the spellings, `--pipeline Q` exits 2;
             `map --graph -o graph-pack-tsv|gaf|paf` byte-identical and
             `genotype --graph --top-n 10` from reads and from a
             '#node_id\tcount' pack through K-H, ranks and pairs equal to
             the host's beyond 1e-6 ties, similarity within 1e-6
The last three lines are the card's name and power limit (as `nvidia-smi`
gives them, also printed first), the kernel table and the result as JSON.  Imports
only impg_tpu_torch and, for phase 5's demo data, examples/ (which reaches
tests/datagen.py and tests/pyref.py): an import guard installed before the
port is imported refuses `jax` and `impg_tpu` (and their submodules) and the
run fails if anything tried to import them.  The port's native host library
(its own g++ build) must load, so that the run measures the native visited
bookkeeping.
"""

from __future__ import annotations

import concurrent.futures
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
import threading
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
# [4 genotype graph]: the truth pair (founders 3 and 4 of the graph's 6)
# and its reads, drawn from the two paths' spellings: an eighth of a 30x
# sample's reads (3.75x; a quarter until [4 graph toolbox] took its share
# of the smoke's clock), since read mapping on the host is most of the
# phase.
GRAPH_TRUTH = ("hap3", "hap16")
GRAPH_READS = N_READS // 8
GRAPH_READ_SEED = 21
# Neighbouring similarities closer than this are float32 ties: the device
# ranking is held to the host's float64 one as sets within them.
GRAPH_TIE = 1e-6
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


def windows_load_latency_us(D) -> float:
    """Microseconds a step of K-B's search loop adds, measured here: K-B's
    device time on one query over a segment of 2^24 records (25 dependent
    probe steps) less that over a segment of one record (one step), over
    the 24 steps between.  Each launches through a `DepthFront` whose
    outputs are made once, outside the timing; the two are timed in turns
    (six rounds, the medians).  The probed lines stay in L2 across
    launches, as the engine's do."""
    fns = {}
    for n in (1, 1 << 24):
        t_start = torch.arange(n, dtype=torch.int32, device=DEVICE)
        front = D.DepthFront(types.SimpleNamespace(
            tgt_offsets=torch.tensor([0, n], dtype=torch.int32,
                                     device=DEVICE),
            t_start=t_start, cummax_te=t_start, window_iters=25,
            device=DEVICE))
        q = torch.tensor([[0], [n // 2], [n // 2 + 1]], dtype=torch.int32,
                         device=DEVICE)
        front.device_windows(*q)
        fns[n] = lambda front=front, q=q: front.device_windows(*q)
    acc = {n: [] for n in fns}
    for r in range(6):
        for n in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            acc[n].append(device_ms(fns[n], reps=50))
    ms = {n: float(np.median(v)) for n, v in acc.items()}
    return (ms[1 << 24] - ms[1]) * 1e3 / 24


def check_windows_past_2_32(D) -> None:
    """K-B's 62-bit carry past 2^31 lanes, on the card: one segment of 2^16
    records that every one of 2^16 + 3 queries overlaps (2^32 + 3 x 2^16
    lanes), through a `DepthFront`'s round trip against the plain twin,
    exact (win_lo, k, offs and the host copies of offs and win_lo)."""
    n = 1 << 16
    t_start = torch.arange(n, dtype=torch.int32, device=DEVICE)
    idx = types.SimpleNamespace(
        tgt_offsets=torch.tensor([0, n], dtype=torch.int32, device=DEVICE),
        t_start=t_start, cummax_te=t_start + 1_000_000,
        window_iters=D._iters_for(n), device=DEVICE)
    b = n + 3
    cols = (np.zeros(b, np.int32), np.full(b, n, np.int32),
            np.full(b, 2_000_000, np.int32))
    front = D.DepthFront(idx)
    _, win_lo, k, offs, offs_h, lo_h = front.windows(*cols,
                                                     host_windows=True)
    q = torch.from_numpy(np.stack(cols)).to(DEVICE)
    plain = D.windows_offsets_plain(idx.tgt_offsets, idx.t_start,
                                    idx.cummax_te, *q, idx.window_iters)
    err = max(max_abs_err(x, y) for x, y in
              zip((win_lo[:b], k[:b], offs[:b + 1]), plain))
    err = max(err, max_abs_err(torch.from_numpy(offs_h.copy()),
                               plain[2].cpu()),
              max_abs_err(torch.from_numpy(lo_h.copy()), plain[0].cpu()))
    total = int(offs_h[-1])
    print(f"[3 kernels] windows/past_2^32 {b} queries x {n} records: "
          f"tolerance=0 (integers) max_abs_err={err} lanes={total}",
          flush=True)
    if err or total != (1 << 32) + 3 * n:
        raise AssertionError("windows/past_2^32: kernel disagrees with twin")


def check_windows(D, d, batch, label: str, step_us: float) -> dict:
    """K-B (windows and lane offsets in one launch) against its plain twin
    on a frontier batch (host int32 columns), exact.  Timed in turns, as
    calls from the host columns to the offsets on the host: the kernel
    through an engine's `DepthFront` (one copy up, one launch, one copy
    back), the plain twin and the library route (two torch.searchsorted
    over composite (tid << 32) | key keys, a clamp and a cumsum) with one
    copy each way; then each route's device time alone (the kernel's:
    the same front's launch on the staged rows, without the copies), and
    the kernel call's host work alone.  Bound: per query its
    three words, win_lo and k, its offset, and for a query on a target its
    two target offsets and its probes, 4 B each; the latency floor: the
    deepest query's dependent loads (its tid, its target offsets, its
    search steps) at the step time that `windows_load_latency_us`
    measured."""
    front = D.DepthFront(d)
    b = int(batch[0].size)
    q, win_lo, k, offs, offs_h, _ = front.windows(*batch)
    q, win_lo, k, offs = q[:, :b], win_lo[:b], k[:b], offs[:b + 1]
    plain = D.windows_offsets_plain(d.tgt_offsets, d.t_start, d.cummax_te,
                                    q[0], q[1], q[2], d.window_iters)
    err = max(max_abs_err(x, y) for x, y in zip((win_lo, k, offs), plain))
    err = max(err, max_abs_err(torch.from_numpy(offs_h.copy()),
                               plain[2].cpu()))
    n_seqs = d.tgt_offsets.shape[0] - 1
    rec_tid = d.target_id.long() << 32
    key_ts = rec_tid | d.t_start.long()
    key_te = rec_tid | d.cummax_te.long()

    def library(qd):
        ok = (qd[0] >= 0) & (qd[0] < n_seqs)
        tid = qd[0].long() << 32
        cut = torch.searchsorted(key_ts, tid | qd[2].long(), right=True)
        lo = torch.searchsorted(key_te, tid | qd[1].long())
        kk = torch.where(ok, torch.clamp(cut - lo, min=0), 0)
        lib_offs = torch.zeros(kk.shape[0] + 1, dtype=torch.int64,
                               device=kk.device)
        lib_offs[1:] = torch.cumsum(kk, 0)
        return lo, kk, lib_offs

    l_lo, l_k, l_offs = library(q)
    if max_abs_err(l_k, k) or max_abs_err(l_offs, offs) or max_abs_err(
            torch.where(k > 0, l_lo, 0), torch.where(k > 0, win_lo, 0)):
        raise AssertionError(f"windows/{label}: the library route disagrees")
    cols = np.stack([np.asarray(a, np.int32) for a in batch])

    def up():
        return D.upload_i32(cols, DEVICE)

    calls = dict(
        kernel=lambda: front.windows(*batch),
        plain=lambda: (lambda qd: D.windows_offsets_plain(
            d.tgt_offsets, d.t_start, d.cummax_te, qd[0], qd[1], qd[2],
            d.window_iters)[2].cpu().numpy())(up()),
        library=lambda: library(up())[2].cpu().numpy(),
    )
    devices = dict(
        kernel=lambda: front.device_windows(q[0], q[1], q[2]),
        library=lambda: library(q),
    )
    t = time_turns(calls, reps=20, rounds=4)
    dev = {name: device_ms(fn, reps=20) for name, fn in devices.items()}
    # The kernel call's host work: the same calls with the foreign call
    # (copies, launch, wait) stubbed out.
    launch = D.kernels.launch
    D.kernels.launch = lambda *a: True
    try:
        front.windows(*batch)
        t0 = time.perf_counter()
        for _ in range(200):
            front.windows(*batch)
        host_ms = (time.perf_counter() - t0) / 200 * 1e3
    finally:
        D.kernels.launch = launch
    tid = q[0].long()
    ok = (tid >= 0) & (tid < n_seqs)
    tid = tid.clamp(0, n_seqs - 1)
    seg_n = (d.tgt_offsets[tid + 1] - d.tgt_offsets[tid]).double()
    steps = torch.ceil(torch.log2(seg_n + 1)) * ok
    probes = int(steps.sum()) * 2
    dependent = int(steps.max()) + 3 if b else 0
    row = dict(
        max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
        library_ms=t["library"], device_ms=dev["kernel"], host_ms=host_ms,
        library_device_ms=dev["library"],
        **bound(b * 28 + 8 + int(ok.sum()) * 8 + probes * 4),
        latency_floor_ms=dependent * step_us / 1e3,
        dependent_loads=dependent,
        shape=f"{b} queries ({label})",
    )
    # A step that did not measure above zero gives no floor.
    floor = (f"{row['latency_floor_ms']:.4f}" if step_us > 0
             else "not_measured")
    print(f"[3 kernels] windows {row['shape']}: tolerance=0 (integers) "
          f"max_abs_err={err} call_ms={t['kernel']:.4f} "
          f"host_ms={host_ms:.4f} "
          f"device_ms={dev['kernel']:.4f} plain_call_ms={t['plain']:.4f} "
          f"library_call_ms={t['library']:.4f} "
          f"library_device_ms={dev['library']:.4f} "
          f"bound_ms={row['bound_ms']:.6f} bound_by={row['bound_by']} "
          f"latency_floor_ms={floor} "
          f"(dependent_loads={dependent} x step_us={step_us:.4f}) "
          f"lanes={int(offs_h[-1])}", flush=True)
    if err:
        raise AssertionError(f"windows/{label}: kernel disagrees with twin")
    return row


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
    win_lo, _, offs = D.windows_offsets(d.tgt_offsets, d.t_start,
                                        d.cummax_te, *fq, d.window_iters)
    offs_h = offs.cpu().numpy()
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


def phase_kernels(eng, index, targets, D, SC, host, step_us: float):
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
    rows["windows"] = check_windows(D, d, front, "depth-2 frontier",
                                    step_us)
    check_windows_past_2_32(D)

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
                       if not k.startswith(("stab_count/", "windows"))})
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


def _device_ops(tp) -> list:
    """[(device us, op name)] of a torch.profiler run's device ops with
    time.  Device events only: a CPU op (aten::copy_) also carries the
    device time of the kernel or copy it issued, which would count it
    twice."""
    events = [e for e in tp.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    attr = ("self_device_time_total"
            if events and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    return [(getattr(e, attr), e.key) for e in events if getattr(e, attr) > 0]


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
    return wall, pstats.Stats(prof).stats, _device_ops(tp)


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




# `partition` of the query index: windows of 50 kb, ranges merged within
# 1 kb, the command's defaults otherwise (3 kb missing and boundary sizes).
PART_WINDOW = 50_000
PART_MERGE = 1_000
# `[4 partition profile]` profiles the first 1/PART_PROFILE_SHARE of the
# partition's walks: per-walk costs show in an eighth as in the whole, and
# the smoke's clock is bounded (a quarter until [4 graph toolbox]).
PART_PROFILE_SHARE = 8
# `refine -x` over the first seeds: flank steps of 10 kb up to half the
# locus, ranges merged within 1 kb (64 seeds until [4 graph toolbox] took
# its share of the smoke's clock).
REFINE_REGIONS = 32
REFINE_STEP = 10_000


class WalkCounter:
    """Counts the transitive walks that partition and refine start (one
    `query_transitive_bfs` each) while it is entered, and with a Recorder
    keeps each walk's frontier batches by depth (`by_depth[1]`, ...)."""

    def __init__(self, engine_mod, rec=None):
        self.mod = engine_mod
        self.rec = rec
        self.walks = 0
        self.by_depth: dict = {}

    def __enter__(self):
        self.orig = self.mod.query_transitive_bfs

        def walk(*a, **kw):
            self.walks += 1
            n0 = len(self.rec.batches) if self.rec else 0
            out = self.orig(*a, **kw)
            for depth, b in enumerate(self.rec.batches[n0:] if self.rec
                                      else (), 1):
                self.by_depth.setdefault(depth, []).append(b)
            return out

        self.mod.query_transitive_bfs = walk
        return self

    def __exit__(self, *exc):
        self.mod.query_transitive_bfs = self.orig


def _folder_bytes(folder: str) -> bytes:
    """Every file of `folder`, name and bytes, in name order."""
    out = b""
    for name in sorted(os.listdir(folder)):
        out += name.encode() + b"\n" + _read(os.path.join(folder, name))
    return out


def _device_busy(dev) -> tuple:
    """(device busy ms, top device ops) of a `profiled` run's device ops."""
    busy = sum(us for us, _ in dev) / 1e3
    top = sorted(dev, reverse=True)[:6]
    return busy, json.dumps([[n, round(us / 1e3, 6)] for us, n in top])


def _host_top(st, n: int = 6) -> str:
    top = sorted(((v[2], k[2]) for k, v in st.items()), reverse=True)[:n]
    return json.dumps([[name, round(t, 6)] for t, name in top])


def phase_partition(eng, index, kernels, D, host, part_mod, engine_mod,
                    tmp: str, step_us: float) -> tuple:
    """`partition` of the query index, one transitive walk a window: on the
    native C++ engine, then on the resident engine with the counts zeroed
    around it (BED bytes equal, the same walks); K-B at a walk's frontiers
    (depth 1, one query, and the median depth-2 batch); the first
    1/PART_PROFILE_SHARE of the walks of one more device run under cProfile
    and torch.profiler.  Returns the table rows and the
    device run's launch counts."""
    def run(engine, name):
        folder = os.path.join(tmp, name)
        t0 = time.perf_counter()
        collected = part_mod.partition_alignments(
            index, PART_WINDOW, merge_distance=PART_MERGE,
            device_engine=engine, output_folder=folder)
        torch.cuda.synchronize()
        return collected, time.perf_counter() - t0, _folder_bytes(folder)

    with WalkCounter(engine_mod) as nat_walks:
        nat, nat_s, nat_bytes = run(host.NativeHostEngine(index), "native")
    rec = Recorder(eng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with WalkCounter(engine_mod, rec) as walks:
        got, dev_s, dev_bytes = run(rec, "device")
    launches = kernels.launch_counts()
    check_launches("partition", launches,
                   ("windows", "project_lanes", "compact"))
    if dev_bytes != nat_bytes or walks.walks != nat_walks.walks:
        raise AssertionError("partition: device partitions differ from the "
                             "native engine's")
    depth2 = sorted(walks.by_depth.get(2, []), key=lambda b: b[0].size)
    if not depth2:
        raise AssertionError("partition: no walk reached depth 2")
    sizes = [int(b[0].size) for b in depth2]
    one = next(b for b in walks.by_depth[1] if b[0].size == 1)
    rows = {
        "windows/walk_depth_1": check_windows(
            D, eng.dindex, one, "a walk's depth 1", step_us),
        "windows/partition_depth_2": check_windows(
            D, eng.dindex, depth2[len(depth2) // 2],
            f"median of {len(depth2)} partition depth-2 frontiers", step_us),
    }
    n_prof = walks.walks // PART_PROFILE_SHARE

    class Enough(Exception):
        """Ends the profiled partition after its first n_prof walks."""

    def first_walks():
        walk = engine_mod.query_transitive_bfs
        done = [0]

        def counted(*a, **kw):
            if done[0] == n_prof:
                raise Enough
            done[0] += 1
            return walk(*a, **kw)

        engine_mod.query_transitive_bfs = counted
        try:
            run(eng, "profiled")
        except Enough:
            pass
        finally:
            engine_mod.query_transitive_bfs = walk

    wall, st, dev = profiled(first_walks)
    busy_ms, dev_top = _device_busy(dev)
    bfs_tt, _ = _frame_times(
        st, "_bfs_many_native",
        os.path.join("impg_tpu_torch", "query", "engine.py"))
    _, stream_ct = _frame_times(
        st, "query_batch_stream",
        os.path.join("impg_tpu_torch", "query", "device.py"))
    print(
        f"[4 partition] window={PART_WINDOW} merge={PART_MERGE} "
        f"walks={walks.walks} partitions={len(got)} "
        f"bed_bytes={len(dev_bytes)} bed_equal_native=True "
        f"device_wall_s={dev_s:.3f} native_wall_s={nat_s:.3f} "
        f"in_engine_s={rec.engine_s:.3f} "
        f"depth2_frontier_queries(min,median,max)="
        f"{sizes[0]},{sizes[len(sizes) // 2]},{sizes[-1]} "
        f"launches={json.dumps(launches)}", flush=True)
    print(
        f"[4 partition profile] walks={n_prof} of {walks.walks} (reduced: "
        f"the first 1/{PART_PROFILE_SHARE}) wall_s={wall:.6f} "
        f"device_busy_ms={busy_ms:.6f} "
        f"device_ms_per_walk={busy_ms / n_prof:.6f} "
        f"device_idle_share={1 - busy_ms / 1e3 / wall:.6f} "
        f"bfs_many_native_tottime_s={bfs_tt:.6f} "
        f"query_batch_stream_cumtime_s={stream_ct:.6f} "
        f"host_tottime_s_top6={_host_top(st)} device_ms_top6={dev_top}",
        flush=True)
    return rows, launches


def phase_refine(eng, index, targets, kernels, host, refine_mod,
                 engine_mod) -> dict:
    """`refine -x` of the first REFINE_REGIONS seeds (flank steps of
    REFINE_STEP), one transitive walk a flank candidate: on the native C++
    engine, then on the resident engine with the counts zeroed around it;
    the written records equal.  Returns the launch counts."""
    regions = [(index.seq_index.get_name(t), (s, e), f"seed{i}")
               for i, (t, s, e) in enumerate(targets[:REFINE_REGIONS])]
    config = refine_mod.RefineConfig(
        extension_step=REFINE_STEP, merge_distance=PART_MERGE,
        use_transitive_bfs=True)

    def run(engine):
        out = io.StringIO()
        t0 = time.perf_counter()
        records = refine_mod.run_refine(index, regions, config,
                                        device_engine=engine)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        refine_mod.write_refine_output(records, out)
        return out.getvalue(), dt, records

    with WalkCounter(engine_mod) as nat_walks:
        nat, nat_s, _ = run(host.NativeHostEngine(index))
    rec = Recorder(eng)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with WalkCounter(engine_mod) as walks:
        got, dev_s, records = run(rec)
    launches = kernels.launch_counts()
    check_launches("refine", launches, ("windows", "project_lanes", "compact"))
    if got != nat or walks.walks != nat_walks.walks:
        raise AssertionError("refine: device records differ from native")
    extended = sum(r.applied_left_extension + r.applied_right_extension > 0
                   for r in records)
    print(
        f"[4 refine] regions={len(regions)} step={REFINE_STEP} "
        f"walks={walks.walks} extended={extended} "
        f"support(min,max)={min(r.support_count for r in records)},"
        f"{max(r.support_count for r in records)} records_equal_native=True "
        f"device_wall_s={dev_s:.3f} native_wall_s={nat_s:.3f} "
        f"in_engine_s={rec.engine_s:.3f} launches={json.dumps(launches)}",
        flush=True)
    return launches

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
    part = ["partition", "-a", paf, "-w", "5000", "-d", "100",
            "--output-folder", "{out}"]
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
        "partition -o bed": (part + ["-o", "bed"], {}, "resident", exact),
        "partition -o paf": (part + ["-o", "paf"], {}, "resident", exact),
        "refine -x": (["refine", "-a", paf, "-r", "ref:2000-8000", "-d",
                       "100", "-x"], {}, "resident", exact),
    }
    # The host runs are subprocesses that depend on nothing here: run them
    # four at a time, before the device runs, for the smoke's clock.
    outs = [[os.path.join(tmp, f"out{i}_{side}") for side in ("h", "d")]
            for i in range(len(checks))]

    def host_ref(i, argv):
        return on_host([a.format(out=outs[i][0]) for a in argv])

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        refs = [ex.submit(host_ref, i, argv)
                for i, (argv, *_rest) in enumerate(checks.values())]
        refs = [f.result() for f in refs]
    parts = []
    for i, (label, (argv, env, kind, path)) in enumerate(checks.items()):
        # Partition writes into --output-folder: its files are compared
        # with the standard output.
        ref, (out_h, out_d) = refs[i], outs[i]
        dev, launches, engines = on_device(
            [a.format(out=out_d) for a in argv], env)
        if os.path.isdir(out_h):
            ref += _folder_bytes(out_h).decode()
            dev += _folder_bytes(out_d).decode()
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
    parts += cli_graph(tmp, on_host, on_device, synth)
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
        check_launches(f"cli {label}", launches, (path,) if path else ())
        if out_of is not None:
            a, b = (_tree_bytes(out_of("host")),
                    _tree_bytes(out_of("device")))
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
    # Read mapping against the index (host in both runs; -o proj's pack
    # through K-G) and the syng backend's queries (host in both runs).
    syngt = idx["host"] + ".syngt"
    for fmt, path in (("gaf", None), ("paf", None), ("proj", "map_pack")):
        both(f"map -a -o {fmt}", lambda e: [
            "map", "-a", syngt, "-q", fq, "-o", fmt, "-O",
            os.path.join(tmp, f"map_{fmt}_{e}")], path,
            lambda e: os.path.join(tmp, f"map_{fmt}_{e}"))
    for fmt in ("bed", "bedpe"):
        for walk in ([], ["-x"]):
            argv = ["query", "-a", syngt, "-r", "ref:2000-8000", "-d",
                    "100", "-o", fmt, *walk]
            ref = on_host(argv)
            dev, launches, _ = on_device(argv, {})
            check_launches(f"cli query .syngt -o {fmt}", launches, ())
            if dev != ref or len(ref.splitlines()) < 2:
                raise AssertionError(f"cli query .syngt -o {fmt} {walk}: "
                                     "device run != host run")
            parts.append(f"query .syngt -o {fmt} {' '.join(walk) or 'raw'}: "
                         f"{len(ref.splitlines())} lines identical")
    return parts


def _tree_bytes(path: str) -> bytes:
    """A file's bytes, or a directory's files (name and bytes, in name
    order)."""
    return _folder_bytes(path) if os.path.isdir(path) else _read(path)


def _report_rows(out: str) -> list:
    return [line.split("\t") for line in out.splitlines()[1:]]


def graph_reports_agree(host: str, dev: str) -> int:
    """`genotype --graph` reports, host (float64 sparse search) against
    device (float32 products and K-H): sample, region and rank equal, and
    the combinations where neighbouring host similarities lie more than
    GRAPH_TIE apart (as sets within such runs, a run the head cuts
    included); similarity within GRAPH_TIE (printed to 6 places: one unit),
    qv within 0.1.  Returns the ties crossed."""
    h, d = _report_rows(host), _report_rows(dev)
    if len(h) != len(d) or len(h) < 2:
        raise AssertionError("genotype --graph: row counts differ")
    ties = 0
    for lo, hi in _tie_groups([float(r[4]) for r in h], 1.0000001e-6):
        if {r[3] for r in h[lo:hi]} != {r[3] for r in d[lo:hi]} \
                and hi < len(h):
            raise AssertionError(f"genotype --graph: ranks {lo}..{hi - 1}")
        ties += hi - lo - 1
    for a, b in zip(h, d):
        if a[:3] != b[:3] or abs(float(a[4]) - float(b[4])) > 1.0000001e-6 \
                or abs(float(a[5]) - float(b[5])) > 0.1000001:
            raise AssertionError(f"genotype --graph: {a} vs {b}")
    return ties


def cli_graph(tmp: str, on_host, on_device, synth) -> list:
    """`map --graph -o graph-pack-tsv|gaf|paf` (host in both runs, bytes
    equal, no launch) on a variation graph of 8 haplotypes of a 50 kb locus
    and 10,000 reads of hap2 and hap5; then `genotype --graph --top-n 10`
    on the device (products and K-H) against the host, from the reads and
    from a '#node_id\tcount' pack of their coverage."""
    from impg_tpu_torch.graph import columnar_ops as co
    from impg_tpu_torch.graph.gfa import Gfa
    from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

    text = synth.variation_graph(seed=3, n_haps=8, locus_len=50_000)
    g = os.path.join(tmp, "gt_locus.gfa")
    with open(g, "w") as fh:
        fh.write(text)
    spell = co.path_spellings(parse_gfa_columns(text))
    fq = os.path.join(tmp, "gt_reads.fq")
    synth.write_fastq(fq, synth.sample_reads(5, [spell["hap2"],
                                                 spell["hap5"]], 10_000))
    parts = []
    for fmt in ("graph-pack-tsv", "gaf", "paf"):
        out = {e: os.path.join(tmp, f"gt_{fmt}_{e}") for e in ("h", "d")}
        on_host(["map", "--graph", g, "-q", fq, "-o", fmt, "-O", out["h"]])
        _, launches, _ = on_device(["map", "--graph", g, "-q", fq, "-o",
                                    fmt, "-O", out["d"]], {})
        check_launches(f"cli map --graph -o {fmt}", launches, ())
        a, b = _read(out["h"]), _read(out["d"])
        if a != b or a.count(b"\n") < 10:
            raise AssertionError(f"cli map --graph -o {fmt}: runs differ")
        parts.append(f"map --graph -o {fmt}: {a.count(b'\n')} lines "
                     "identical")
    # The pack: node i = the graph's i-th S line (1-based).
    ords = {sid: i + 1 for i, sid in enumerate(Gfa.parse(text).segments)}
    pack = os.path.join(tmp, "gt_pack.tsv")
    with open(pack, "w") as fh:
        fh.write("#node_id\tcount\n")
        for line in _read(os.path.join(tmp, "gt_graph-pack-tsv_h")
                          ).decode().splitlines()[2:]:
            sid, bp = line.split("\t")
            fh.write(f"{ords[sid]}\t{bp}\n")
    for label, src in (("reads", ["-q", fq]), ("pack", ["-p", pack])):
        argv = ["genotype", "cos", "--graph", g, *src, "--top-n", "10"]
        ref = on_host(argv)
        dev, launches, _ = on_device(argv, {})
        check_launches(f"cli genotype --graph ({label})", launches,
                       ("diploid",))
        ties = graph_reports_agree(ref, dev)
        parts.append(f"genotype --graph from {label}: "
                     f"{len(_report_rows(ref))} rows, ranks and pairs equal "
                     f"to the host's ({ties} ties), launches "
                     f"{json.dumps(launches)}")
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
    # An eighth of one epoch of the host numpy loop (a sample a step; 27.1
    # s for the whole epoch on an H100 host), for the smoke's clock.
    t0 = time.perf_counter()
    step_node, step_pos_c, bounds = sortgfa.sgd_inputs(gc)
    sortgfa._sgd_order_core(gc.n_segs, step_node, step_pos_c, bounds,
                            epochs=1, batch_per_step=1, backend="numpy")
    host_eighth_s = time.perf_counter() - t0
    print(f"[4 sort] segments={gc.n_segs} steps={n_steps} "
          f"samples_per_epoch={8 * n_steps} epochs=30 wall_s={wall:.3f} "
          + " ".join(f"{k}_s={v:.3f}" for k, v in times.items())
          + f" launches={json.dumps(launches)} max_memory_allocated="
          f"{peak} spellings_equal={len(after)}/{SORT_HAPS} "
          f"renumbered_1_to_N_topological=True "
          f"spearman_rank_vs_path0={rho:.6f} "
          f"host_numpy_eighth_epoch_s={host_eighth_s:.3f} "
          f"(extrapolated, not run: an epoch {8 * host_eighth_s:.1f}s, 30 "
          f"epochs {240 * host_eighth_s:.1f}s)", flush=True)
    return launches


def _tie_groups(sims: list, tol: float) -> list:
    """[lo, hi) index ranges of a ranking's runs of neighbouring
    similarities closer than `tol`."""
    groups, lo = [], 0
    for i in range(1, len(sims) + 1):
        if i == len(sims) or abs(sims[i] - sims[i - 1]) > tol:
            groups.append((lo, i))
            lo = i
    return groups


def ranking_agrees(head: list, full: list, tol: float) -> int:
    """Whether the ranking `head` (CombinationScores, possibly cut short)
    is `full`'s (every pair, host float64) but for the order inside runs of
    neighbouring similarities within `tol`: each run of `full` covered by
    the head holds the same pairs, the run the head cuts holds the head's
    last pairs.  Raises AssertionError if not; returns the ties crossed."""
    pairs = [tuple(r.combination) for r in full]
    ties = 0
    for lo, hi in _tie_groups([r.similarity for r in full], tol):
        if lo >= len(head):
            break
        got = {tuple(r.combination) for r in head[lo:min(hi, len(head))]}
        if not got <= set(pairs[lo:hi]) or (
                hi <= len(head) and got != set(pairs[lo:hi])):
            raise AssertionError(f"ranks {lo}..{hi - 1}: {sorted(got)} "
                                 f"against {sorted(pairs[lo:hi])}")
        ties += hi - lo - 1
    return ties


def exact_coverage(gc, haps, depth: int) -> dict:
    """The coverage (covered bp by segment ordinal) that `depth`x reads of
    the paths `haps` would leave if each were credited to its own path:
    depth x length x visits.  Length-normalized, it is depth times the sum
    of the two candidates' rows, so that pair's cosine is 1."""
    rows = gc.seg_row_of_name()
    lens = gc.seg_lens()
    visits = np.zeros(gc.n_segs, np.int64)
    for h in haps:
        p = gc.path_names.index(h)
        np.add.at(visits, rows[gc.step_name_idx[gc.path_off[p]:
                                                gc.path_off[p + 1]]], 1)
    hit = np.nonzero(visits)[0]
    return {int(f): float(depth * lens[f] * visits[f]) for f in hit}


def phase_genotype_graph(text, gc, kernels, co, gt_graph, gt_core, gfa_mod,
                         OD, synth, tmp: str) -> tuple:
    """`genotype_graph` on the [4 sort] graph, each run with the launch
    counts zeroed around it.  From reads: GRAPH_READS reads of the truth
    pair mapped to the 90 path walks on the host (`map_reads_to_graph`),
    the candidates x segments matrix, the cuBLAS products and K-H at top_n
    = GT_TOP_N, each stage timed (module functions wrapped for the run),
    the device's busy time from torch.profiler, the head held to the host
    float64 `run_diploid_topk` of the same matrix beyond GRAPH_TIE ties, and
    the truth pair's rank reported.  From the truth pair's exact coverage
    (the pack route, `sample_counts`) with every pair ranked (top_n None:
    kk = n^2, K-H's keep-every-key route): the truth pair first, the
    ranking the host's.  Then K-H against its twin at that kk
    (`diploid/graph_keep_all`).  Returns (table rows, launches)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    spell = co.path_spellings(gc)
    fq = os.path.join(tmp, "graph_reads.fq")
    synth.write_fastq(fq, synth.sample_reads(
        GRAPH_READ_SEED, [spell[h] for h in GRAPH_TRUTH], GRAPH_READS,
        READ_LEN))
    del spell
    print(f"[setup] graph genotype reads: {GRAPH_READS} x {READ_LEN} bp of "
          f"{'+'.join(GRAPH_TRUTH)}, generated in "
          f"{time.perf_counter() - t0:.1f}s; reduced: {GRAPH_READS} of a "
          f"30x sample's {N_READS} reads (host read mapping's time)",
          flush=True)

    times: dict = {}
    seen: dict = {}
    n_topk = [0]

    def synced(key, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            return out
        return _timed(times, key, run)

    def keep_args(fn):
        def run(*a, **kw):
            seen["dense"] = (a[0], a[1])
            return fn(*a, **kw)
        return run

    def counted(fn):
        def run(*a, **kw):
            n_topk[0] += 1
            return fn(*a, **kw)
        return run

    def genotype(label, reads, counts, top_n):
        """One genotype_graph run on the card: (candidates, results, wall
        s, launches, K-H calls)."""
        calls = n_topk[0]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cands, res, _ = gt_graph.genotype_graph(
            text, reads, sample_counts=counts, device=True, top_n=top_n,
            torch_device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        check_launches(f"genotype graph {label}", launches, ("diploid",))
        if launches["diploid"] != n_topk[0] - calls:
            raise AssertionError(f"genotype graph {label}: K-H counted "
                                 f"{launches['diploid']} launches for "
                                 f"{n_topk[0] - calls} calls")
        return cands, res, wall, launches, n_topk[0] - calls

    parse = gfa_mod.Gfa.__dict__["parse"]
    patched = [
        (gt_graph, "collect_graph_candidates",
         _timed(times, "candidates", gt_graph.collect_graph_candidates)),
        (gt_graph, "map_reads_to_graph",
         _timed(times, "read_mapping", gt_graph.map_reads_to_graph)),
        (gt_core, "run_diploid_topk", keep_args(
            _timed(times, "device_step", gt_core.run_diploid_topk))),
        (gt_core, "upload", synced("upload", gt_core.upload)),
        (OD, "products", synced("products", OD.products)),
        (OD, "diploid_topk", counted(synced("k_h", OD.diploid_topk))),
    ]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    try:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
        gfa_mod.Gfa.parse = classmethod(
            _timed(times, "parse", parse.__func__))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as tp:
            cands, head, wall, launches, calls = genotype(
                "from reads", [fq], None, GT_TOP_N)
        stage = dict(times)
        reads_dense = seen["dense"]
        truth_counts = exact_coverage(gc, GRAPH_TRUTH, 15)
        cands_all, ranked, wall_all, all_launches, _ = genotype(
            "from the truth's coverage", [], truth_counts, None)
        truth_dense = seen["dense"]
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        gfa_mod.Gfa.parse = parse
    busy_ms, dev_top = _device_busy(_device_ops(tp))
    names = [c.path_name for c in cands]
    if [c.path_name for c in cands_all] != names or len(names) != SORT_HAPS:
        raise AssertionError("genotype graph: candidates differ between runs")
    n, d = reads_dense[0].shape
    pairs = n * (n + 1) // 2

    def pair(r):
        return "+".join(sorted(names[i] for i in r.combination))

    truth = "+".join(sorted(GRAPH_TRUTH))
    t0 = time.perf_counter()
    host = gt_core.run_diploid_topk(*reads_dense, pairs, device=False)
    host_s = time.perf_counter() - t0
    ties = ranking_agrees(head, host, GRAPH_TIE)
    order = [pair(r) for r in host]
    host_all = gt_core.run_diploid_topk(*truth_dense, pairs, device=False)
    ties_all = ranking_agrees(ranked, host_all, GRAPH_TIE)
    if len(ranked) != pairs or pair(ranked[0]) != truth \
            or pair(host_all[0]) != truth \
            or abs(ranked[0].similarity - 1.0) > GRAPH_TIE:
        raise AssertionError(f"genotype graph from the truth's coverage: "
                             f"{pair(ranked[0])} first of {len(ranked)}")
    dense_s = wall - sum(stage.get(k, 0.0) for k in (
        "parse", "candidates", "read_mapping", "device_step"))
    print(f"[4 genotype graph] {n} candidates x {d} segments, "
          f"{GRAPH_READS} reads of {truth}: wall_s={wall:.3f} "
          + " ".join(f"{k}_s={stage.get(k, 0.0):.6f}" for k in (
              "parse", "candidates", "read_mapping", "upload", "products",
              "k_h", "device_step"))
          + f" dense_build_and_rest_s={dense_s:.3f} "
          f"device_busy_ms={busy_ms:.6f} "
          f"device_idle_share={1 - busy_ms / 1e3 / wall:.6f} "
          f"device_ms_top6={dev_top} launches={json.dumps(launches)} "
          f"k_h_calls={calls}; head of {len(head)} equal to the host "
          f"float64 ranking beyond {GRAPH_TIE} ties ({ties} tied "
          f"neighbours), host_f64_run_diploid_topk_s={host_s:.3f}; top1="
          f"{pair(head[0])} (sim {head[0].similarity:.6f}); truth {truth} "
          f"rank {order.index(truth) + 1} of {pairs} on the host (reads "
          f"that every path shares go to the first path, {names[0]}: "
          f"{sum(names[0] in p.split('+') for p in order[:10])} of the top "
          f"10 pairs hold it)", flush=True)
    print(f"[4 genotype graph] from the truth's exact coverage (15x, the "
          f"pack route), every pair ranked: wall_s={wall_all:.3f} "
          f"launches={json.dumps(all_launches)} top1={pair(ranked[0])} "
          f"(sim {ranked[0].similarity:.7f}); {len(ranked)} pairs equal to "
          f"the host float64 ranking beyond {GRAPH_TIE} ties ({ties_all} "
          f"tied neighbours)", flush=True)
    kk = n * n
    dense, sample_vec = truth_dense
    c = dense.astype(gt_core._narrowest_upload_dtype(dense))
    prods, _, err = _diploid_case(OD, c, sample_vec, kk)
    rows = {"diploid/graph_keep_all": _diploid_row(
        OD, prods, kk, err, f"{n}x{n} pairs from the graph's {n}x{d} "
        f"{c.dtype}, kk={kk} (keep-every-key route)")}
    print_kernel_rows(rows)
    launches = {k: v + all_launches[k] for k, v in launches.items()}
    return rows, launches


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


# [4 sequence]: the sequence layer and the POA region outputs on a panel of
# one locus (synth.panel_alignments: base, 6 founders, 90 haplotypes of
# about 1 Mb, 96 exact alignments), walked with -x -m 2 -d 0.
SEQ_SEED = 7
SEQ_FASTA_WINDOWS = 64      # query -o fasta|fasta+paf: 10 kb windows
SEQ_FASTA_WIDTH = 10_000
SEQ_POA_WINDOWS = 4         # query -o gfa|maf|fasta-aln|vcf, similarity
SEQ_POA_WIDTH = 2_000
SEQ_PART_WINDOW = 100_000   # partition -o fasta over the whole panel
# partition -o gfa runs POA on every partition, whose cost grows with the
# square of its length: it runs on a cut of the panel (18 haplotypes of
# 8 kb, 2 kb windows) so that the phase stays inside its time budget.
SEQ_GFA_PANEL = dict(n_haps=18, length=8_000)
SEQ_GFA_WINDOW = 2_000
SEQ_POA_FORMATS = ("gfa", "maf", "fasta-aln", "vcf")
WALK_PATH = ("windows", "project_lanes", "compact")


def _row_array(rows) -> np.ndarray:
    """A walk's rows (Row objects) as a sorted [n, 6] int64 array."""
    cols = np.array([[r.q_id, r.q_first, r.q_last, r.t_id, r.t_first,
                      r.t_last] for r in rows], np.int64).reshape(-1, 6)
    return cols[np.lexsort(cols.T[::-1])]


class StageClock:
    """While entered: the seconds spent in the walks
    (`engine.query_transitive_bfs_many`, through which every single walk
    goes too) and in each of `stages`, (module, function name, stage)
    triples; a call counts in the stage of the outermost timed call it runs
    under (crush's and smooth's POA in theirs), threads included.  Each
    walk's rows are kept as a sorted array, taken before the caller merges
    them."""

    def __init__(self, engine_mod, stages):
        self.targets = ((engine_mod, "query_transitive_bfs_many", "walk"),
                        *stages)
        self.s = {stage: 0.0 for _, _, stage in self.targets}
        self.rows: list = []
        self.depth = 0
        self.lock = threading.Lock()

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in self.targets]
        for (mod, name, stage), (_, _, fn) in zip(self.targets, self.saved):
            setattr(mod, name, self._timed(fn, stage))
        return self

    def _timed(self, fn, stage):
        def timed(*a, **kw):
            with self.lock:
                self.depth += 1
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
            finally:
                with self.lock:
                    self.depth -= 1
                    if self.depth == 0:
                        self.s[stage] += time.perf_counter() - t0
            if stage == "walk":
                self.rows.extend(_row_array(r) for r in out)
            return out
        return timed

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def cli_run(kernels, stages, argv, engine, out=None, traced=False):
    """The port's CLI in this process, `argv` with `--compute-engine
    engine`, the launch counts zeroed around it and its stages timed
    (`StageClock`; its `stderr` holds the run's standard error): (output
    bytes, wall s, clock, launches, device busy ms or None, runs made).  A traced run whose trace holds no device op though
    it launched kernels (torch.profiler lost the first traces of
    `[4 sequence]` after the earlier phases' in one chip run) runs once
    more; if that trace is empty too, its busy time is not measured
    (None)."""
    from torch.profiler import ProfilerActivity, profile

    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.query import engine as engine_mod

    for attempt in range(2 if traced else 1):
        buf = io.StringIO()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with contextlib.ExitStack() as st:
            clock = st.enter_context(StageClock(engine_mod, stages))
            tp = (st.enter_context(profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]))
                  if traced else None)
            st.enter_context(contextlib.redirect_stdout(buf))
            err = st.enter_context(contextlib.redirect_stderr(io.StringIO()))
            t0 = time.perf_counter()
            rc = tcli.main([*argv, "--compute-engine", engine],
                           device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        clock.stderr = err.getvalue()
        launches = kernels.launch_counts()
        if rc != 0:
            raise RuntimeError(f"cli {argv} {engine} rc={rc}: "
                               f"{clock.stderr[-2000:]}")
        ops = _device_ops(tp) if traced else []
        if ops or not any(launches.values()):
            break
    if out is None:
        data = buf.getvalue().encode()
    elif os.path.isdir(out):
        data = _folder_bytes(out)
    else:
        data = _read(out)
    busy = sum(us for us, _ in ops) / 1e3 if ops else None
    return data, wall, clock, launches, busy, attempt + 1


def device_share(busy, wall: float) -> str:
    """The card's busy ms and idle share of a traced run's wall s."""
    if busy is None:
        return "device_busy_ms=not_measured"
    return (f"device_busy_ms={busy:.6f} "
            f"device_idle_share={1 - busy / 1e3 / wall:.6f}")


def windows_equal(label: str, dev, rows: list, one: bytes, ref) -> None:
    """Every window's walk rows of the device run `dev` equal the native
    engine's (`rows`, one array a window), and the native run `ref` over
    the first window equals the device run's first window (`one`, selected
    from the device output)."""
    if len(dev[2].rows) != len(rows):
        raise AssertionError(f"{label}: {len(dev[2].rows)} walks, not "
                             f"{len(rows)}")
    for i, (a, b) in enumerate(zip(dev[2].rows, rows)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: window {i} rows differ from the "
                                 "native engine's")
    if one != ref[0] or not one:
        pairs = zip(one.splitlines(), ref[0].splitlines())
        diff = next(((i, a[:200], b[:200]) for i, (a, b)
                     in enumerate(pairs) if a != b), None)
        raise AssertionError(f"{label}: the first window's output differs "
                             f"from the native run's ({len(one)} against "
                             f"{len(ref[0])} bytes; first different line: "
                             f"{diff})")


def sequence_data(tmp: str, synth, name: str, **kw) -> tuple:
    """A panel_alignments panel written as `name`.fa (one line a sequence)
    and `name`.paf under `tmp`: (FASTA path, PAF path, sequences)."""
    seqs, paf_text = synth.panel_alignments(seed=SEQ_SEED, **kw)
    fa, paf = (os.path.join(tmp, f"{name}.{ext}") for ext in ("fa", "paf"))
    synth.write_fasta(fa, seqs)
    with open(paf, "w") as fh:
        fh.write(paf_text)
    return fa, paf, seqs


def _bed(path: str, windows: list) -> str:
    with open(path, "w") as fh:
        for s, e in windows:
            fh.write(f"base\t{s}\t{e}\n")
    return path


def phase_sequence(tmp: str, kernels, synth) -> dict:
    """`query -o fasta|fasta+paf|gfa|maf|fasta-aln|vcf`, `similarity --pca`
    and `partition -o fasta|gfa` through the port's CLI in this process,
    `--compute-engine device` on the card against the native (or, for
    fasta+paf, which stores CIGARs, the host) engine.  Each device run has
    the launch counts zeroed around it and must launch K-B, K-C and K-D and
    nothing else, and runs under torch.profiler (the card's busy time and
    idle share); its walks and POA are timed (`StageClock`), the rest is
    sequence fetch, merge, text and writing.  fasta, fasta+paf and the
    partitions: bytes equal to the other engine's run.  POA formats and
    similarity (POA's cost grows with the square of the window, so not every
    POA runs twice): each window's walk rows equal to the native engine's,
    and the output of one window, run natively, equal to the device run's
    output for that window.  Returns the panel's and the cut panel's files,
    the 2 kb windows and their native walk rows, for `[4 graph
    pipeline]`, and the 10 kb windows, for `[4 tracepoint files]`."""
    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.graph import poa as poa_mod
    from impg_tpu_torch.host import NativeHostEngine, load_or_build
    from impg_tpu_torch.query import engine as engine_mod

    t_phase = t0 = time.perf_counter()
    fa, paf, seqs = sequence_data(tmp, synth, "panel")
    gen_s = time.perf_counter() - t0
    base_len = len(seqs[0][1])
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        if tcli.main(["index", "-a", paf], device=DEVICE) != 0:
            raise RuntimeError("sequence: index failed")
    index_s = time.perf_counter() - t0
    index = load_or_build([paf])
    print(f"[setup] sequence panel: {len(seqs)} sequences "
          f"({sum(len(s) for _, s in seqs)} bp; base {base_len} bp), "
          f"{len(index.records)} directed records, {index.arena.n_ops} "
          f"arena runs; generated and written in {gen_s:.1f}s, indexed by "
          f"the CLI in {index_s:.1f}s; reduced: partition -o gfa on a cut "
          f"panel ({SEQ_GFA_PANEL['n_haps']} haplotypes of "
          f"{SEQ_GFA_PANEL['length']} bp, {SEQ_GFA_WINDOW} bp windows)",
          flush=True)

    step = (base_len - 2 * SEQ_FASTA_WIDTH) // SEQ_FASTA_WINDOWS
    fasta_win = [(SEQ_FASTA_WIDTH + i * step,
                  SEQ_FASTA_WIDTH + i * step + SEQ_FASTA_WIDTH)
                 for i in range(SEQ_FASTA_WINDOWS)]
    step = base_len // (SEQ_POA_WINDOWS + 1)
    poa_win = [((i + 1) * step, (i + 1) * step + SEQ_POA_WIDTH)
               for i in range(SEQ_POA_WINDOWS)]
    fasta_bed = _bed(os.path.join(tmp, "fasta.bed"), fasta_win)
    poa_bed = _bed(os.path.join(tmp, "poa.bed"), poa_win)
    one_bed = _bed(os.path.join(tmp, "one.bed"), poa_win[:1])
    walk = ["-x", "-m", "2", "-d", "0", "--sequence-files", fa]
    poa_rows = [_row_array(r) for r in engine_mod.query_transitive_bfs_many(
        index, [(index.seq_index.get_id("base"), s, e) for s, e in poa_win],
        max_depth=2, device_engine=NativeHostEngine(index))]

    poa_stage = [(poa_mod, "poa_align", "poa")]

    def run(argv, engine, out=None, traced=False):
        return cli_run(kernels, poa_stage, argv, engine, out, traced)

    def report(label, dev, ref_engine, n_walks, extra=""):
        data, wall, clock, launches, busy, runs = dev
        check_launches(f"sequence {label}", launches, WALK_PATH)
        if len(clock.rows) != n_walks:
            raise AssertionError(f"sequence {label}: {len(clock.rows)} walks, "
                                 f"not {n_walks}")
        rest = wall - clock.s["walk"] - clock.s["poa"]
        device = device_share(busy, wall)
        print(
            f"[4 sequence] {label}: walks={n_walks} "
            f"rows={sum(len(r) for r in clock.rows)} wall_s={wall:.3f} "
            f"walk_s={clock.s['walk']:.3f} poa_s={clock.s['poa']:.3f} "
            f"write_s={rest:.3f} {device} traced_runs={runs} "
            f"out_bytes={len(data)} {extra}equal_{ref_engine}=True "
            f"launches={json.dumps(launches)}", flush=True)

    # query -o fasta and fasta+paf: 64 windows a run, bytes equal.
    for fmt, ref_engine in (("fasta", "native"), ("fasta+paf", "host")):
        argv = ["query", "-a", paf, "-b", fasta_bed, *walk, "-o", fmt]
        outs = [os.path.join(tmp, f"q_{fmt}_{e}") for e in ("d", "r")]
        dev = run(argv + ["-O", outs[0]], "device", outs[0], traced=True)
        ref = run(argv + ["-O", outs[1]], ref_engine, outs[1])
        if dev[0] != ref[0] or not dev[0]:
            raise AssertionError(f"sequence -o {fmt}: device bytes differ "
                                 f"from the {ref_engine} engine's")
        if len(dev[2].rows) != len(ref[2].rows) or not all(
                np.array_equal(a, b) for a, b in zip(dev[2].rows,
                                                     ref[2].rows)):
            raise AssertionError(f"sequence -o {fmt}: walk rows differ "
                                 f"from the {ref_engine} engine's")
        report(f"query -o {fmt}", dev, ref_engine, SEQ_FASTA_WINDOWS,
               f"{ref_engine}_wall_s={ref[1]:.3f} ")
        os.remove(outs[0])
        os.remove(outs[1])

    for fmt in SEQ_POA_FORMATS:
        argv = ["query", "-a", paf, *walk, "-o", fmt]
        dev = run(argv + ["-b", poa_bed], "device", traced=True)
        ref = run(argv + ["-b", one_bed], "native")
        # The device run writes its windows in order: the first is a prefix.
        windows_equal(f"sequence query -o {fmt}", dev, poa_rows,
                      dev[0][:len(ref[0])], ref)
        report(f"query -o {fmt}", dev, "native", SEQ_POA_WINDOWS,
               f"native_wall_s_one_window={ref[1]:.3f} ")

    argv = ["similarity", "-a", paf, *walk, "--pca"]
    dev = run(argv + ["-b", poa_bed], "device", traced=True)
    ref = run(argv + ["-b", one_bed], "native")
    s, e = poa_win[0]
    first = [ln for ln in dev[0].decode().splitlines(keepends=True)
             if ln.startswith(("chrom\t", f"base\t{s}\t{e}\t",
                               f"#PCA\tbase:{s}-{e}\t"))]
    windows_equal("sequence similarity --pca", dev, poa_rows,
                  "".join(first).encode(), ref)
    n_pca = sum(ln.startswith("#PCA\t") for ln in dev[0].decode().splitlines())
    report("similarity --pca", dev, "native", SEQ_POA_WINDOWS,
           f"pca_lines={n_pca} native_wall_s_one_window={ref[1]:.3f} ")

    # partition -o fasta over the panel, -o gfa over its cut: every file of
    # the output folder byte for byte.
    gfa_fa, gfa_paf, _ = sequence_data(tmp, synth, "cut", **SEQ_GFA_PANEL)
    for fmt, (pfa, ppaf, width) in (
            ("fasta", (fa, paf, SEQ_PART_WINDOW)),
            ("gfa", (gfa_fa, gfa_paf, SEQ_GFA_WINDOW))):
        argv = ["partition", "-a", ppaf, "-w", str(width), "-d", "0",
                "-o", fmt, "--sequence-files", pfa, "--output-folder"]
        outs = [os.path.join(tmp, f"p_{fmt}_{e}") for e in ("d", "n")]
        dev = run(argv + [outs[0]], "device", outs[0], traced=True)
        ref = run(argv + [outs[1]], "native", outs[1])
        if dev[0] != ref[0] or not dev[0]:
            raise AssertionError(f"sequence partition -o {fmt}: device "
                                 "files differ from the native engine's")
        report(f"partition -o {fmt}", dev, "native", len(ref[2].rows),
               f"files={len(os.listdir(outs[0]))} "
               f"native_wall_s={ref[1]:.3f} ")
        shutil.rmtree(outs[0])
        shutil.rmtree(outs[1])
    print(f"[4 sequence] phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return dict(fa=fa, paf=paf, windows=poa_win, rows=poa_rows,
                fasta_windows=fasta_win, cut=(gfa_fa, gfa_paf))


# [4 graph pipeline]: the seqwish, syng-native and pggb region engines, the
# `gfa:` post-processing stages and `.syngt` region outputs, each device run
# walked on the card as [4 sequence]'s POA formats are.  All-vs-all
# alignment of a 2 kb window of the full panel aligns 9,312 ordered pairs of
# its 97 sequences on the host, one by one: the full panel runs the pggb engine
# (alignment, seqwish and the whole chain) on the first GP_FULL_WINDOWS of
# [4 sequence]'s 2 kb windows and the whole `gfa:` pipeline over POA on
# the first of them; the
# seqwish, syng-native, vcf and `gfa:sgd` over pggb runs and the `.syngt`
# queries run on [4 sequence]'s cut panel (25 sequences, 600 pairs).
GP_FULL_WINDOWS = 2
GP_CUT_WINDOWS = ((1000, 3000), (3000, 5000), (5000, 7000))
GP_PIPELINE = ("gfa:cut-n=100:sort:sgd:smooth,block-len=900:normalize:"
               "crush:selfloops")
GP_FULL_RUNS = (["-o", "gfa", "--gfa-engine", "pggb"], ["-o", GP_PIPELINE])
GP_CUT_RUNS = (["-o", "gfa", "--gfa-engine", "seqwish"],
               ["-o", "gfa", "--gfa-engine", "syng-native"],
               ["-o", "vcf", "--gfa-engine", "seqwish"],
               ["-o", "gfa:sgd", "--gfa-engine", "pggb"])
GP_SYNG_QUERIES = (["-x", "-o", "bed"], ["-o", "gfa"], ["-x", "-o", "gfa"],
                   ["-x", "-o", "fasta"], ["-x", "-o", "maf"],
                   ["-x", "-o", "fasta-aln"], ["-x", "-o", "vcf"],
                   ["-x", "-o", "gfa:sort"])
# The host stages a run's wall s splits into, besides the walk and the rest.
GP_STAGE_NAMES = ("align_induce", "poa", "cut_n", "sort", "smooth",
                  "normalize", "crush", "selfloops")


def graph_stages() -> list:
    """StageClock's stages of a region graph run: pairwise alignment and
    seqwish induction, POA, cut-n, and the chain's and the `gfa:` pipeline's
    stages (pggb's chain calls the same functions)."""
    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.commands import align as align_mod
    from impg_tpu_torch.graph import (crush, gfa, normalize, poa, seqwish,
                                      selfloops, smooth, sortgfa)

    return [(align_mod, "align_sequence_pair", "align_induce"),
            (seqwish, "induce_graph", "align_induce"),
            (poa, "poa_align", "poa"),
            (tcli, "_clip_terminal_n_runs", "cut_n"),
            (gfa, "topological_sort", "sort"),
            (sortgfa, "sort_pipeline", "sort"),
            (smooth, "smooth_gfa", "smooth"),
            (smooth, "smooth_gfa_passes", "smooth"),
            (normalize, "normalize_gfa", "normalize"),
            (crush, "crush_gfa", "crush"),
            (selfloops, "normalize_self_loops", "selfloops")]


def phase_graph_pipeline(tmp: str, kernels, seq: dict) -> tuple:
    """`query -o gfa|vcf --gfa-engine seqwish|syng-native|pggb`, `-o
    gfa:<stages>` and `.syngt` region outputs through the port's CLI in
    this process, on [4 sequence]'s panels.  Each device run has the launch
    counts zeroed around it and must launch K-B, K-C and K-D and nothing
    else, runs under torch.profiler (the card's busy time and idle share)
    and has its host stages timed (`graph_stages`); every window's walk rows
    equal the native engine's and the first window's output, run natively,
    equals the device run's (standard error too, where crush and cut-n
    write their lines).  The `.syngt` runs: the cut panel's syng index built
    with `syng --compute-engine device` (K-F, equal to the host build's
    bytes), then each query's output on it equal to that on the host-built
    index (`-x -o bed` with sequence files: refined chain ends), no kernel
    launched (the syng walk is the host's).  Returns the two syng index
    files by engine, for `[4 tracepoint files]` and `[4 syng tools]`, and
    the pggb engine's window graphs of the full panel (`pggb_gfas`, one GFA
    text a window of `pggb_windows`), for `[4 graph toolbox]`."""
    from impg_tpu_torch.host import NativeHostEngine, load_or_build
    from impg_tpu_torch.query import engine as engine_mod

    t_phase = time.perf_counter()
    stages = graph_stages()
    cut_fa, cut_paf = seq["cut"]
    cut_index = load_or_build([cut_paf])
    cut_rows = [_row_array(r) for r in engine_mod.query_transitive_bfs_many(
        cut_index, [(cut_index.seq_index.get_id("base"), s, e)
                    for s, e in GP_CUT_WINDOWS],
        max_depth=2, device_engine=NativeHostEngine(cut_index))]
    full_win = seq["windows"][:GP_FULL_WINDOWS]
    print(f"[setup] graph pipeline: {GP_FULL_WINDOWS} of [4 sequence]'s "
          f"2 kb windows of the full panel ({', '.join(f'base:{s}-{e}' for s, e in full_win)}) "
          f"for the pggb engine and the first for {GP_PIPELINE}; the cut "
          f"panel "
          f"({len(cut_index.seq_index)} sequences, {len(GP_CUT_WINDOWS)} "
          f"windows of 2 kb) for the rest; reduced: the seqwish, "
          f"syng-native, vcf and gfa:sgd-over-pggb runs and the .syngt "
          f"queries on the cut panel, since all-vs-all alignment of the full "
          f"panel aligns 9,312 pairs a window on the host", flush=True)

    def run_set(tag, fa, paf, windows, rows, argv_tail):
        walk = ["query", "-a", paf, "-x", "-m", "2", "-d", "0",
                "--sequence-files", fa, *argv_tail]
        beds = [_bed(os.path.join(tmp, f"gp_{tag}_{n}.bed"), w)
                for n, w in (("all", windows), ("one", windows[:1]))]
        dev = cli_run(kernels, stages, walk + ["-b", beds[0]], "device",
                      traced=True)
        ref = cli_run(kernels, stages, walk + ["-b", beds[1]], "native")
        label = f"{tag} panel {' '.join(argv_tail)}"
        check_launches(f"graph pipeline {label}", dev[3], WALK_PATH)
        # Windows are written in order: the first is a prefix.
        windows_equal(f"graph pipeline {label}", dev, rows,
                      dev[0][:len(ref[0])], ref)
        if not dev[2].stderr.startswith(ref[2].stderr):
            raise AssertionError(f"graph pipeline {label}: the first "
                                 "window's standard error differs from the "
                                 "native run's")
        data, wall, clock, launches, busy, runs = dev
        staged = " ".join(f"{k}_s={clock.s[k]:.3f}" for k in GP_STAGE_NAMES)
        rest = wall - sum(clock.s.values())
        print(f"[4 graph pipeline] {label}: walks={len(windows)} "
              f"rows={sum(len(r) for r in clock.rows)} wall_s={wall:.3f} "
              f"walk_s={clock.s['walk']:.3f} {staged} rest_s={rest:.3f} "
              f"{device_share(busy, wall)} traced_runs={runs} "
              f"out_bytes={len(data)} stderr_lines="
              f"{len(clock.stderr.splitlines())} "
              f"native_wall_s_one_window={ref[1]:.3f} equal_native=True "
              f"launches={json.dumps(launches)}", flush=True)
        return data

    # The pggb engine's window graphs, one GFA a window, for [4 graph
    # toolbox].
    pggb_gfas = split_gfas(run_set("full", seq["fa"], seq["paf"], full_win,
                                   seq["rows"][:GP_FULL_WINDOWS],
                                   GP_FULL_RUNS[0]).decode())
    if len(pggb_gfas) != GP_FULL_WINDOWS:
        raise AssertionError(f"graph pipeline: {len(pggb_gfas)} pggb window "
                             f"graphs, not {GP_FULL_WINDOWS}")
    # The whole `gfa:` pipeline on the first window alone (two took 28.6 s
    # on an H100 host, crush 20.3 of it), for the smoke's clock.
    for tail in GP_FULL_RUNS[1:]:
        run_set("full", seq["fa"], seq["paf"], full_win[:1],
                seq["rows"][:1], tail)
    for tail in GP_CUT_RUNS:
        run_set("cut", cut_fa, cut_paf, list(GP_CUT_WINDOWS), cut_rows,
                tail)

    # .syngt: the cut panel's syng index built on the card and on the host,
    # then region queries over both, with sequence files.
    syngt = {}
    for engine in ("device", "host"):
        prefix = os.path.join(tmp, f"gp_syng_{engine}")
        built = cli_run(kernels, [], ["syng", "-f", cut_fa, "-o", prefix],
                        engine, prefix + ".syngt")
        syngt[engine] = (prefix + ".syngt", built)
    dev_build, host_build = syngt["device"][1], syngt["host"][1]
    check_launches("graph pipeline syng", dev_build[3], ("syncmer_scan",))
    if dev_build[0] != host_build[0] or not dev_build[0]:
        raise AssertionError("graph pipeline syng: the device index differs "
                             "from the host build's")
    s, e = GP_CUT_WINDOWS[1]
    parts = []
    for tail in GP_SYNG_QUERIES:
        outs = []
        for engine in ("device", "host"):
            argv = ["query", "-a", syngt[engine][0], "-r", f"base:{s}-{e}",
                    "-d", "0", "--sequence-files", cut_fa, *tail]
            outs.append(cli_run(kernels, [], argv, engine))
            check_launches(f"graph pipeline .syngt {' '.join(tail)}",
                           outs[-1][3], ())
        if outs[0][0] != outs[1][0] or len(outs[0][0].splitlines()) < 2:
            raise AssertionError(f"graph pipeline .syngt {' '.join(tail)}: "
                                 "output on the device-built index differs "
                                 "from the host-built index's")
        parts.append(f"{' '.join(tail)} {len(outs[0][0])} bytes "
                     f"{outs[0][1]:.3f}s")
    print(f"[4 graph pipeline] .syngt base:{s}-{e} with sequence files: "
          f"syng --compute-engine device {dev_build[1]:.3f}s against host "
          f"{host_build[1]:.3f}s, {len(dev_build[0])} bytes equal, launches "
          f"{json.dumps(dev_build[3])}; queries on the device-built index "
          f"equal to the host-built index's, no kernel launched: "
          f"{'; '.join(parts)}", flush=True)
    print(f"[4 graph pipeline] phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)
    return ({engine: syngt[engine][0] for engine in syngt},
            dict(pggb_gfas=pggb_gfas, pggb_windows=full_win))


def split_gfas(text: str) -> list:
    """Concatenated GFAs (one a window, each from its H line) apart."""
    parts = []
    for line in text.splitlines(keepends=True):
        if line.startswith("H\t") or not parts:
            parts.append("")
        parts[-1] += line
    return parts



# [4 tracepoint files]: .1aln and .tpa files into the main path.  Fast mode
# (no sequences) on its own index of TP_N_ALN alignments, written as each
# of the four files, ingested by the CLI's `index` and walked by the device
# and native engines (cut from a tenth of the query tier's alignments: at
# 25,000 this phase and [4 syng tools] took 179.1 s on an H100 host against
# the 150 s they may take of the smoke, and at 15,000 129.3 + 3.7 s; cut
# again, with exact mode, when [4 graph toolbox] came, to keep the smoke
# under its 1200 s); exact mode (with sequences) on the sequence panel's
# first TP_EXACT_ALNS alignments (native realignment of every trace segment
# is the cost: about 20 s a file for 16); `-o gbwt` on the full panel and
# on the cut panel's syng index.
TP_N_ALN = 6_000
TP_SPACING = 100
TP_EXACT_ALNS = 8
TP_STATS_REGIONS = 4096
APPROX_PATH = ("windows", "project_approx", "compact")


def _members(path: str) -> dict:
    """A numpy zip's members and their bytes (the zip itself carries its
    write time)."""
    import zipfile

    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def host_run(kernels, argv) -> tuple:
    """A host subcommand of the port's CLI (no `--compute-engine`) in this
    process with the launch counts zeroed around it: (stdout bytes, wall s,
    stderr, launches); fails unless it exits 0 and launches nothing."""
    from impg_tpu_torch import cli as tcli

    kernels.reset_launch_counts()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tcli.main(argv, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    if rc != 0:
        raise RuntimeError(f"cli {argv} rc={rc}: {err.getvalue()[-2000:]}")
    check_launches(f"cli {argv[0]}", launches, ())
    return out.getvalue().encode(), wall, err.getvalue(), launches


def _index_arrays(index) -> dict:
    """An index's records, arena runs and sequence names, for equality."""
    cols = {f"records.{f.name}": getattr(index.records, f.name)
            for f in dataclasses.fields(index.records)}
    cols["arena.runs"] = index.arena.runs
    cols["names"] = np.array([index.seq_index.get_name(i)
                              for i in range(len(index.seq_index))])
    return cols


def _bed_rows(data: bytes) -> dict:
    """BED rows keyed by (name column, sequence): their (start, end)s in
    order."""
    rows: dict = {}
    for ln in data.decode().splitlines():
        f = ln.split("\t")
        rows.setdefault((f[3], f[0]), []).append((int(f[1]), int(f[2])))
    return rows


def bed_differences(got: bytes, ref: bytes) -> tuple:
    """(rows of `got` not in `ref` or the reverse, the largest bp shift of
    a row paired in order under the same window and sequence)."""
    a, b = _bed_rows(got), _bed_rows(ref)
    differ = max_bp = 0
    for key in set(a) | set(b):
        ra, rb = a.get(key, []), b.get(key, [])
        differ += abs(len(ra) - len(rb))
        for x, y in zip(ra, rb):
            if x != y:
                differ += 1
                max_bp = max(max_bp, abs(x[0] - y[0]), abs(x[1] - y[1]))
    return differ, max_bp


def phase_tracepoint_files(tmp: str, kernels, synth, seq: dict,
                           syngt: dict) -> None:
    """`.1aln` and `.tpa` into the main path through the port's CLI in this
    process.  Fast mode: an index of TP_N_ALN alignments written with
    write_1aln (ASCII, binary) and write_tpa (fastga, standard), each file
    ingested by `index` without sequences, then `query -x` of the 256
    seeds, the same walk `--approximate`, and `stats -b` over K-A's
    regions, each on the device engine (traced; K-B, K-C and K-D, K-B, K-E
    and K-D, K-A launched and nothing else) against the native engine (the
    host's for `stats`): bytes equal, and the ASCII and binary files give
    equal indexes.  Exact mode: `export-1aln --binary` and `export-tpa` of
    the sequence panel's first TP_EXACT_ALNS alignments, then `query -x -o
    bed --sequence-files` over [4 sequence]'s 64 windows of 10 kb, native
    (ingest included) against device: bytes equal; the rows that differ
    from the PAF-built index's are counted.  `-o gbwt` over [4 sequence]'s
    4 windows of 2 kb, device against native, and of the cut panel's
    `.syngt` on the device-built and host-built index: the regional
    `.syngt` members equal."""
    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.host import load_or_build
    from impg_tpu_torch.io import onealn, tpa

    t_phase = t0 = time.perf_counter()
    index = synth.realistic_directed_index(seed=3, n_seqs=N_SEQS,
                                           seq_len=SEQ_LEN, n_aln=TP_N_ALN)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tp = index.ensure_tracepoints(TP_SPACING)
    tp_s = time.perf_counter() - t0
    print(f"[setup] tracepoint files: {len(index.records)} directed records, "
          f"{index.arena.n_ops} arena runs, {tp.q_bound.size} tracepoint "
          f"boundaries; generated in {gen_s:.1f}s, tracepoints in "
          f"{tp_s:.1f}s; reduced: n_aln {TP_N_ALN} of the query tier's "
          f"{N_ALN} (at 25000, a tenth, this phase and [4 syng tools] took "
          f"179.1 s on an H100 host against their 150 s share of the "
          f"smoke; at 15000 133.0 s; cut for [4 graph toolbox]); exact mode "
          f"on the sequence panel's first {TP_EXACT_ALNS} alignments (16 "
          f"took about 20 s a file)", flush=True)
    names = index.seq_index.get_name
    seeds = os.path.join(tmp, "tp_seeds.bed")
    with open(seeds, "w") as fh:
        for tid, s, e in scale_queries(len(index.seq_index), N_SEEDS):
            fh.write(f"{names(tid)}\t{s}\t{e}\n")
    regions = os.path.join(tmp, "tp_regions.bed")
    with open(regions, "w") as fh:
        for tid, s, e in zip(*(a.tolist() for a in
                               random_regions(TP_STATS_REGIONS))):
            if tid >= 0:
                fh.write(f"{names(tid)}\t{s}\t{e}\n")
    writers = {
        "ascii.1aln": lambda p: onealn.write_1aln(
            p, index.seq_index, index.records, index.arena, tp),
        "binary.1aln": lambda p: onealn.write_1aln(
            p, index.seq_index, index.records, index.arena, tp, binary=True),
        "fastga.tpa": lambda p: tpa.write_tpa(
            p, index.seq_index, index.records, index.arena, tp,
            tp_type="fastga"),
        "standard.tpa": lambda p: tpa.write_tpa(
            p, index.seq_index, index.records, index.arena, tp,
            tp_type="standard"),
    }
    walks = (
        ("query -x", ["query", "-b", seeds, "-x", "-d", "100"], "native",
         WALK_PATH),
        ("query -x --approximate", ["query", "-b", seeds, "-x", "-d", "100",
                                    "--approximate"], "native", APPROX_PATH),
        ("stats -b", ["stats", "-b", regions], "host", ("stab_count",)),
    )
    built = {}
    for name, write in writers.items():
        path = os.path.join(tmp, "tp_" + name)
        t0 = time.perf_counter()
        n_written = write(path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            if tcli.main(["index", "-a", path], device=DEVICE) != 0:
                raise RuntimeError(f"tracepoint files: index {name} failed")
        ingest_s = time.perf_counter() - t0
        built[name] = load_or_build([path])
        parts = []
        for label, argv, ref_engine, path_kernels in walks:
            full = [argv[0], "-a", path, *argv[1:]]
            dev = cli_run(kernels, [], full, "device", traced=True)
            ref = cli_run(kernels, [], full, ref_engine)
            check_launches(f"tracepoint files {name} {label}", dev[3],
                           path_kernels)
            if dev[0] != ref[0] or len(dev[0].splitlines()) < 2:
                raise AssertionError(f"tracepoint files {name} {label}: "
                                     f"device output differs from the "
                                     f"{ref_engine} engine's")
            data, wall, clock, launches, busy, runs = dev
            walk_s = clock.s["walk"]
            rate = (f"walk_s={walk_s:.3f} seeds_per_s={N_SEEDS / walk_s:.2f} "
                    if walk_s else "")
            parts.append(f"{label}: wall_s={wall:.3f} {rate}"
                         f"{ref_engine}_wall_s={ref[1]:.3f} "
                         f"{device_share(busy, wall)} traced_runs={runs} "
                         f"lines={len(data.splitlines())} "
                         f"equal_{ref_engine}=True "
                         f"launches={json.dumps(launches)}")
        print(f"[4 tracepoint files] {name}: alignments={n_written} "
              f"export_s={export_s:.3f} bytes={os.path.getsize(path)} "
              f"ingest_s={ingest_s:.3f} records={len(built[name].records)} "
              f"runs={built[name].arena.n_ops}; " + "; ".join(parts),
              flush=True)
    a, b = (_index_arrays(built[n]) for n in ("ascii.1aln", "binary.1aln"))
    if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k])
                                       for k in a):
        raise AssertionError("tracepoint files: the ASCII and binary .1aln "
                             "give different indexes")
    del built, index, tp
    torch.cuda.empty_cache()

    # Exact mode: the sequence panel's first alignments, with sequences.
    cut_paf = os.path.join(tmp, "tp_exact.paf")
    with open(seq["paf"]) as src, open(cut_paf, "w") as fh:
        fh.writelines(src.readlines()[:TP_EXACT_ALNS])
    bed = _bed(os.path.join(tmp, "tp_exact.bed"), seq["fasta_windows"])
    walk = ["-b", bed, "-x", "-m", "2", "-d", "0", "--sequence-files",
            seq["fa"], "-o", "bed"]
    paf_ref = cli_run(kernels, [], ["query", "-a", cut_paf, *walk], "native")
    exports = (("binary.1aln", ["export-1aln", "--binary"]),
               ("fastga.tpa", ["export-tpa"]))
    outs = []
    for name, cmd in exports:
        path = os.path.join(tmp, "tp_exact_" + name)
        _, export_s, err, _ = host_run(
            kernels, [cmd[0], "-a", cut_paf, *cmd[1:], "-o", path])
        ref = cli_run(kernels, [], ["query", "-a", path, *walk], "native")
        dev = cli_run(kernels, [], ["query", "-a", path, *walk], "device",
                      traced=True)
        check_launches(f"tracepoint files exact {name}", dev[3], WALK_PATH)
        if dev[0] != ref[0] or len(dev[0].splitlines()) < 2:
            raise AssertionError(f"tracepoint files exact {name}: device "
                                 "bytes differ from the native engine's")
        outs.append(dev[0])
        differ, max_bp = bed_differences(dev[0], paf_ref[0])
        data, wall, clock, launches, busy, runs = dev
        print(f"[4 tracepoint files] exact {name}: export_s={export_s:.3f} "
              f"bytes={os.path.getsize(path)} native_ingest_and_walk_s="
              f"{ref[1]:.3f} device_wall_s={wall:.3f} "
              f"walk_s={clock.s['walk']:.3f} {device_share(busy, wall)} "
              f"traced_runs={runs} lines={len(data.splitlines())} "
              f"equal_native=True rows_differing_from_paf={differ} "
              f"max_bp={max_bp} launches={json.dumps(launches)}",
              flush=True)

    # -o gbwt: the full panel's 2 kb windows; the cut panel's .syngt.
    poa_bed = _bed(os.path.join(tmp, "tp_gbwt.bed"), seq["windows"])
    members = []
    for engine in ("device", "native"):
        prefix = os.path.join(tmp, f"tp_gbwt_{engine}")
        run = cli_run(kernels, [], [
            "query", "-a", seq["paf"], "-b", poa_bed, "-x", "-m", "2", "-d",
            "0", "-o", "gbwt", "--sequence-files", seq["fa"], "-O", prefix],
            engine, traced=engine == "device")
        members.append((_members(prefix + ".syngt"), run))
    (dev_m, dev), (ref_m, ref) = members
    check_launches("tracepoint files -o gbwt", dev[3], WALK_PATH)
    if dev_m != ref_m:
        raise AssertionError("tracepoint files -o gbwt: the device run's "
                             ".syngt differs from the native run's")
    s, e = GP_CUT_WINDOWS[1]
    syng_m = []
    for engine, path in syngt.items():
        prefix = os.path.join(tmp, f"tp_syng_gbwt_{engine}")
        run = cli_run(kernels, [], [
            "query", "-a", path, "-r", f"base:{s}-{e}", "-d", "0", "-o",
            "gbwt", "--sequence-files", seq["cut"][0], "-O", prefix],
            engine)
        check_launches(".syngt -o gbwt", run[3], ())
        syng_m.append((_members(prefix + ".syngt"), run[1]))
    if syng_m[0][0] != syng_m[1][0]:
        raise AssertionError("tracepoint files .syngt -o gbwt: the device-"
                             "built index's regional index differs")
    print(f"[4 tracepoint files] query -o gbwt: {len(seq['windows'])} "
          f"windows of 2 kb, device wall_s={dev[1]:.3f} "
          f"walk_s={dev[2].s['walk']:.3f} {device_share(dev[4], dev[1])} "
          f"native_wall_s={ref[1]:.3f} syngt_bytes="
          f"{sum(len(v) for v in dev_m.values())} members_equal=True "
          f"launches={json.dumps(dev[3])}; .syngt base:{s}-{e} -o gbwt "
          f"{syng_m[0][1]:.3f}s, equal on the device-built and host-built "
          f"index, no kernel launched", flush=True)
    print(f"[4 tracepoint files] phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)


# [4 syng tools]: host tools over [4 graph pipeline]'s cut-panel syng index
# (built on the card) and the cut panel's FASTA; reads of two of its
# haplotypes mapped on the card (K-G) and on the host.
SYNG_TOOLS_SOURCES = ("hap0", "hap1")
SYNG_TOOLS_READS = 2_000
SYNG_TOOLS_WINDOW = 1000


def _fasta_dict(path: str) -> dict:
    out, name = {}, None
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\n")
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                out[name] = b""
            else:
                out[name] += line
    return out


def spell_gfa(text: str) -> dict:
    """Each P or W line's spelling from the S lines."""
    from impg_tpu_torch.io.fasta import reverse_complement

    segs, paths = {}, {}
    lines = [ln.split("\t") for ln in text.splitlines()]
    for f in lines:
        if f[0] == "S":
            segs[f[1]] = f[2].encode()
    for f in lines:
        if f[0] == "P":
            steps = [(st[:-1], st[-1] == "-") for st in f[2].split(",")]
            name = f[1]
        elif f[0] == "W":
            import re

            steps = [(sid, o == "<")
                     for o, sid in re.findall(r"([<>])([^<>]+)", f[6])]
            name = f[3]
        else:
            continue
        paths[name] = b"".join(
            reverse_complement(segs[sid]) if rev else segs[sid]
            for sid, rev in steps)
    return paths


def phase_syng_tools(tmp: str, kernels, synth, seq: dict,
                     syngt: dict) -> None:
    """`syng2gfa` (blunt, raw, blunt with `--gfa-version 1.1`),
    `syng-repair --force`, `read-index`, `map -o pack|gaf` (device: K-G for
    the pack; host) and `infer` with `--gaf`, `--read-index` and
    `--write-haplotypes`, on the cut panel's device-built syng index.
    Gates: every blunt path spells its sequence; the repaired index loads
    with the original's occurrence arrays; the host tools launch nothing;
    the pack run launches K-G alone; infer's report and haplotype FASTAs
    from the device-mapped pack and GAF equal those from the host-mapped
    ones.  The share of windows calling the two source haplotypes is
    printed, not gated (impg_tpu's first-path rule for shared syncmers)."""
    from impg_tpu_torch.syng.index import SyngIndex

    t_phase = time.perf_counter()
    fa = seq["cut"][0]
    index = syngt["device"]
    seqs = _fasta_dict(fa)
    parts = []
    for label, extra in (("blunt", []), ("raw", ["--mode", "raw"]),
                         ("blunt 1.1", ["--gfa-version", "1.1"])):
        out = os.path.join(tmp, f"st_{label.replace(' ', '_')}.gfa")
        _, wall, _, _ = host_run(kernels, ["syng2gfa", "-a", index,
                                           "--sequence-files", fa, *extra,
                                           "-o", out])
        text = _read(out).decode()
        counts = {t: sum(ln.startswith(t + "\t") for ln in text.splitlines())
                  for t in ("S", "L", "P", "W")}
        if label != "raw":
            spelled = spell_gfa(text)
            if spelled.keys() != seqs.keys() or any(
                    spelled[n] != seqs[n] for n in seqs):
                raise AssertionError(f"syng tools syng2gfa {label}: a path "
                                     "does not spell its sequence")
        parts.append(f"syng2gfa {label} {wall:.3f}s "
                     + " ".join(f"{t}={n}" for t, n in counts.items() if n)
                     + (" spelled_exactly=True" if label != "raw" else ""))
    copy = os.path.join(tmp, "st_repair.syngt")
    shutil.copy(index, copy)
    _, wall, err, _ = host_run(kernels, ["syng-repair", copy, "--force"])
    before, after = SyngIndex.load(index), SyngIndex.load(copy)
    for k in ("occ_ids", "occ_seq", "occ_pos", "occ_fwd"):
        if not np.array_equal(getattr(before, k), getattr(after, k)):
            raise AssertionError(f"syng tools syng-repair: {k} changed")
    parts.append(f"syng-repair --force {wall:.3f}s ({err.strip()}) "
                 "occurrences_equal=True")
    reads = os.path.join(tmp, "st_reads.fq")
    synth.write_fastq(reads, synth.sample_reads(
        31, [seqs[h] for h in SYNG_TOOLS_SOURCES], SYNG_TOOLS_READS))
    ridx = os.path.join(tmp, "st_reads")
    _, wall, err, _ = host_run(kernels, ["read-index", "-q", reads, "-O",
                                         ridx])
    parts.append(f"read-index {wall:.3f}s ({err.strip().split(' -> ')[0]})")
    print("[4 syng tools] " + "; ".join(parts), flush=True)

    maps = {}
    for engine in ("device", "host"):
        pack = os.path.join(tmp, f"st_{engine}.packt")
        gaf = os.path.join(tmp, f"st_{engine}.gaf")
        p = cli_run(kernels, [], ["map", "-a", index, "-q", reads, "-o",
                                  "pack", "-O", pack], engine, pack)
        g = cli_run(kernels, [], ["map", "-a", index, "-q", reads, "-o",
                                  "gaf", "-O", gaf], engine, gaf)
        check_launches(f"syng tools map -o pack {engine}", p[3],
                       ("map_pack",) if engine == "device" else ())
        check_launches(f"syng tools map -o gaf {engine}", g[3], ())
        maps[engine] = (pack, gaf, p[1], g[1], p[3])
    src = SYNG_TOOLS_SOURCES[0]
    results = {}
    for engine, (pack, gaf, *_rest) in maps.items():
        prefix = os.path.join(tmp, f"st_hap_{engine}")
        report, wall, _, _ = host_run(kernels, [
            "infer", "-a", index, "-p", pack, "-r",
            f"{src}:0-{len(seqs[src])}", "-w", str(SYNG_TOOLS_WINDOW),
            "--gaf", gaf, "--read-index", ridx + ".readidx",
            "--read-link-weight", "0.5", "--write-haplotypes", prefix,
            "--sequence-files", fa])
        fastas = b"".join(_read(f"{prefix}_hap{k}.fa") for k in range(2))
        results[engine] = (report, fastas, wall)
    if results["device"][:2] != results["host"][:2]:
        raise AssertionError("syng tools infer: the report or haplotypes "
                             "from the device-mapped pack and GAF differ "
                             "from the host-mapped ones'")
    calls = [ln.split("\t")[5] for ln in results["device"][0].decode()
             .splitlines() if ln.startswith("window\t")]
    truth = sum(set(c.split("|")) == set(SYNG_TOOLS_SOURCES) for c in calls)
    dev, host = maps["device"], maps["host"]
    print(f"[4 syng tools] map {SYNG_TOOLS_READS} reads of "
          f"{'+'.join(SYNG_TOOLS_SOURCES)}: -o pack device {dev[2]:.3f}s "
          f"(launches {json.dumps(dev[4])}) host {host[2]:.3f}s; -o gaf "
          f"device {dev[3]:.3f}s host {host[3]:.3f}s; infer {src}:0-"
          f"{len(seqs[src])} -w {SYNG_TOOLS_WINDOW} --gaf --read-index "
          f"--read-link-weight 0.5 --write-haplotypes: "
          f"{results['device'][2]:.3f}s from the device maps, "
          f"{results['host'][2]:.3f}s from the host maps, report and "
          f"haplotypes equal ({len(results['device'][0])} and "
          f"{len(results['device'][1])} bytes); windows={len(calls)} "
          f"calling_{'+'.join(SYNG_TOOLS_SOURCES)}={truth} "
          f"share={truth / max(len(calls), 1):.3f} (information, not a "
          "gate)", flush=True)
    print(f"[4 syng tools] phase_s={time.perf_counter() - t_phase:.1f}",
          flush=True)


# [4 graph toolbox]: the GFA toolbox commands through the port's CLI in this
# process, on the data the earlier phases built: [4 graph pipeline]'s pggb
# window graphs of the full panel (post-processing, calls, reports,
# rendering, lacing), the [4 sort] graph (a columnar report; `project` of
# the GAF that `map --graph -o gaf` writes for [4 genotype graph]'s reads),
# [4 sequence]'s cut panel (alignment and whole-input graphs), the panel
# FASTA (an `.agz` archive and a walk's sequences through it) and render
# bundles of one of its 2 kb windows.  Every command runs on the host, as
# in impg_tpu: each is timed by its host stages, traced for the card's busy
# time, and must launch no kernel except the walk of `query -o fasta` (K-B,
# K-C, K-D) and, past AUTO_DEVICE_SAMPLES, pggb's two Ygs layouts (K-I).
TB_BUDGET_S = 120
TB_JOBS = 4                 # --run-joblist: the job list's first jobs
TB_PROJECT_READS = 10_000   # of [4 genotype graph]'s reads, for map and project
# map --graph and project: the sort graph cut to these paths (the truth
# pair's among them).
TB_PROJECT_PATHS = ("hap0", "hap1", "hap2") + GRAPH_TRUTH
TB_PARTITION_SIZE = 2_000   # graph --partition-size on the cut panel
TB_POA_SEQS = 8             # graph --gfa-engine poa: the cut panel's first
TB_AGZ_WINDOWS = 16         # query -o fasta through the archive: the first
                            # of [4 sequence]'s 10 kb windows
TB_REPORT_FORMATS = ("md", "json", "tsv")


def toolbox_stages() -> list:
    """StageClock's stages of a toolbox command: graph_stages' and each
    toolbox module's work."""
    from impg_tpu_torch.commands import project
    from impg_tpu_torch.genotype import graph as gt_graph
    from impg_tpu_torch.graph import (bubbles, gfa_columns, lace,
                                      render_svg, vcf, vcf_lace)
    from impg_tpu_torch.io import agz

    return graph_stages() + [
        (gfa_columns, "parse_gfa_columns", "parse"),
        (gfa_columns, "report_columns", "report"),
        (bubbles, "decompose_flubbles", "flubbles"),
        (vcf, "gfa_to_vcf", "vcf"),
        (vcf, "gfa_to_vcf_flubbles", "vcf"),
        (render_svg, "render_svg", "svg"),
        (lace, "lace_gfas", "lace"),
        (vcf_lace, "lace_vcfs", "lace"),
        (agz, "create_agz", "agz"),
        (gt_graph, "map_reads_to_graph", "read_mapping"),
        (project, "project_gaf", "project")]


class SgdSamples:
    """While entered: the samples (steps x 8 a step x epochs) of every
    layout `sortgfa._sgd_order_core` is asked for (pggb's two Ygs sorts)."""

    def __init__(self, sortgfa):
        self.mod, self.samples = sortgfa, []

    def __enter__(self):
        self.fn = fn = self.mod._sgd_order_core

        def counted(n, step_node, step_pos, bounds, epochs=30,
                    batch_per_step=8, *a, **kw):
            self.samples.append(np.asarray(step_node).size * batch_per_step
                                * epochs)
            return fn(n, step_node, step_pos, bounds, epochs, batch_per_step,
                      *a, **kw)
        self.mod._sgd_order_core = counted
        return self

    def __exit__(self, *exc):
        self.mod._sgd_order_core = self.fn


def toolbox_run(kernels, argv, engine=None, out=None) -> dict:
    """One toolbox command of the port's CLI in this process (with
    `--compute-engine engine` when given), the launch counts zeroed around
    it, its stages timed, its Ygs samples counted and the card traced:
    dict(data (stdout, or the `out` file's bytes), wall, clock, launches,
    busy ms or None, samples, stderr); fails unless it exits 0."""
    from torch.profiler import ProfilerActivity, profile

    from impg_tpu_torch import cli as tcli
    from impg_tpu_torch.graph import sortgfa
    from impg_tpu_torch.query import engine as engine_mod

    buf, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with contextlib.ExitStack() as st:
        clock = st.enter_context(StageClock(engine_mod, toolbox_stages()))
        sgd = st.enter_context(SgdSamples(sortgfa))
        tp = st.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]))
        st.enter_context(contextlib.redirect_stdout(buf))
        st.enter_context(contextlib.redirect_stderr(err))
        t0 = time.perf_counter()
        try:
            rc = tcli.main(argv + (["--compute-engine", engine] if engine
                                   else []), device=DEVICE)
        except SystemExit as e:  # argparse's exit: keep its message
            rc = e.code
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"graph toolbox {argv[0]} rc={rc}: "
                           f"{err.getvalue()[-2000:]}")
    launches, ops = kernels.launch_counts(), _device_ops(tp)
    # A trace with no device op is an idle card only if nothing launched
    # (torch.profiler has lost traces in full smokes): else not measured.
    busy = (sum(us for us, _ in ops) / 1e3 if ops
            else None if any(launches.values()) else 0.0)
    return dict(data=buf.getvalue().encode() if out is None else _read(out),
                wall=wall, clock=clock, launches=launches, busy=busy,
                samples=sgd.samples, stderr=err.getvalue())


def toolbox_line(label: str, runs: list, size: str, path: tuple = (),
                 extra: str = "") -> float:
    """Print a command's line (its runs' wall s, the host stages that took
    most of it, the card's busy ms and idle share, K-I's launches and the
    Ygs samples against AUTO_DEVICE_SAMPLES) after checking that its runs
    launched the kernels of `path` and no other: its wall s in all."""
    from impg_tpu_torch.graph import sortgfa

    launches = {k: sum(r["launches"][k] for r in runs)
                for k in runs[0]["launches"]}
    samples = [s for r in runs for s in r["samples"]]
    if any(s >= sortgfa.AUTO_DEVICE_SAMPLES for s in samples):
        path = tuple(path) + ("path_sgd",)
    check_launches(f"graph toolbox {label}", launches, path)
    wall = sum(r["wall"] for r in runs)
    busy = (None if any(r["busy"] is None for r in runs)
            else sum(r["busy"] for r in runs))
    stages: dict = {}
    for r in runs:
        for k, v in r["clock"].s.items():
            stages[k] = stages.get(k, 0.0) + v
    stages["rest"] = wall - sum(stages.values())
    top = sorted(((v, k) for k, v in stages.items() if v > 0),
                 reverse=True)[:3]
    sgd = (f" ygs_samples={samples} threshold="
           f"{sortgfa.AUTO_DEVICE_SAMPLES}" if samples else "")
    print(f"[4 graph toolbox] {label}: {size} runs={len(runs)} "
          f"wall_s={wall:.3f} ("
          + ", ".join(f"{w:.3f}" for w in (r["wall"] for r in runs))
          + ") top_stages=" + json.dumps([[k, round(v, 3)] for v, k in top])
          + f" {device_share(busy, wall)} path_sgd_launches="
          f"{launches['path_sgd']}{sgd} {extra}".rstrip(), flush=True)
    return wall


def _spells(label: str, text: str, truth: dict) -> int:
    """Every path of `text` spells its `truth` sequence (or its reverse
    complement, for a path written on the other strand): the paths
    checked."""
    from impg_tpu_torch.io.fasta import reverse_complement

    spelled = spell_gfa(text)
    if not spelled:
        raise AssertionError(f"graph toolbox {label}: no path")
    for name, s in spelled.items():
        want = truth.get(name)
        if want is None or s not in (want, reverse_complement(want)):
            raise AssertionError(f"graph toolbox {label}: path {name} does "
                                 "not spell its sequence")
    return len(spelled)


def _slices(fa: dict, names) -> dict:
    """`NAME:START-END` path names to their slices of the FASTA `fa`."""
    out = {}
    for n in names:
        base, _, rng = n.rpartition(":")
        s, _, e = rng.partition("-")
        out[n] = fa[base][int(s):int(e)]
    return out


def _laced_spells(laced: str, gfas: list, fa: dict) -> int:
    """Every path of the laced graph spells its pieces (the window graphs'
    paths of its sequence inside its range, as they spell) joined by the
    FASTA `fa` between them: the paths checked."""
    pieces: dict = {}
    for g in gfas:
        for name, s in spell_gfa(_read(g).decode()).items():
            base, _, rng = name.rpartition(":")
            a, _, b = rng.partition("-")
            pieces.setdefault(base, []).append((int(a), int(b), s))
    spelled = spell_gfa(laced)
    for name, got in spelled.items():
        base, _, rng = name.rpartition(":")
        a, _, b = rng.partition("-")
        ps = sorted(p for p in pieces.get(base, ())
                    if int(a) <= p[0] and p[1] <= int(b))
        want = ps[0][2] if ps else None
        for prev, cur in zip(ps, ps[1:]):
            want += fa[base][prev[1]:cur[0]] + cur[2]
        if not ps or (ps[0][0], ps[-1][1]) != (int(a), int(b)) \
                or got != want:
            raise AssertionError(f"graph toolbox lace: path {name} does not "
                                 "spell its pieces and the gaps between")
    return len(spelled)


def _vcf_records(text: str) -> list:
    """A VCF's records as (the first nine columns, {sample: genotype}),
    missing genotypes ('./.', as lace fills them) left out."""
    samples, out = [], []
    for ln in text.splitlines():
        f = ln.split("\t")
        if ln.startswith("#CHROM"):
            samples = f[9:]
        elif ln and not ln.startswith("#"):
            out.append((f[:9], {s: g for s, g in zip(samples, f[9:])
                                if g != "./."}))
    return out


def _window_vcf(text: str, s: int, e: int) -> str:
    """A genome-frame VCF of the window `base:s-e` written in the window's
    frame (CHROM `base:s-e`, POS from the window's start), as `lace`
    takes per-window VCFs."""
    out = []
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            f = ln.split("\t")
            f[0], f[1] = f"{f[0]}:{s}-{e}", str(int(f[1]) - s)
            ln = "\t".join(f)
        out.append(ln)
    return "\n".join(out) + "\n"


def phase_graph_toolbox(tmp: str, kernels, synth, seq: dict,
                        pipeline: dict) -> float:
    """Every GFA toolbox command but those of the [4 sort] graph
    (`toolbox_sort_graph`): on the pggb window graphs `normalize`,
    `normalize-self-loops` (and `--diagnose`), `smooth`, `crush`,
    `render-graph`, `gfa2vcf` (both `--sites`), `graph-report` (md, json,
    tsv, `--flubbles`) and `lace` of the windows' graphs (`--fill-gaps`
    with the panel FASTA) and VCFs; on the cut panel `align` (all pairs,
    then `--job-list` and `--run-joblist` of its first TB_JOBS jobs) and
    `graph` (poa, seqwish, pggb, `-a` with align's PAF,
    `--partition-size`); on the panel `agz create|list` and `query -o
    fasta` of [4 sequence]'s 10 kb windows through the archive; `render -x`
    of a window with the poa and pggb engines and `--render-graph`.  Gates:
    exit status 0; output graphs spell their input paths (laced ones the
    sequence between their ends); `graph -a` equals `graph`; each
    run-joblist pair file equals align's rows of that pair; the archive
    holds the FASTA and its query bytes equal the FASTA's; report_columns
    equals report on the window graphs; the render manifest names every
    file the bundle holds.  Returns the phase's seconds."""
    from impg_tpu_torch.graph import gfa as gfa_mod
    from impg_tpu_torch.graph import gfa_columns
    from impg_tpu_torch.io import agz as agz_mod

    t_phase = time.perf_counter()
    fa, paf = seq["fa"], seq["paf"]
    cut_fa, _ = seq["cut"]
    panel = _fasta_dict(fa)
    cut = _fasta_dict(cut_fa)
    wins = pipeline["pggb_windows"]
    gfas = []
    for i, text in enumerate(pipeline["pggb_gfas"]):
        gfas.append(os.path.join(tmp, f"tb_w{i}.gfa"))
        with open(gfas[-1], "w") as fh:
            fh.write(text)
    print(f"[setup] graph toolbox: [4 graph pipeline]'s pggb graphs of "
          f"{', '.join(f'base:{s}-{e}' for s, e in wins)} ("
          + ", ".join(f"{os.path.getsize(g)} bytes" for g in gfas)
          + f"); [4 sequence]'s cut panel ({len(cut)} sequences, "
          f"{sum(len(v) for v in cut.values())} bp) and panel "
          f"({len(panel)} sequences, {sum(len(v) for v in panel.values())} "
          f"bp); reduced: align --run-joblist runs the first {TB_JOBS} "
          f"jobs (one process each); whole-input graphs and the pggb "
          f"render on the cut panel (the full panel aligns 9,312 pairs a "
          f"2 kb window: 19.5 s a render on an H100 host); graph --gfa-engine "
          f"poa on the cut panel's first {TB_POA_SEQS} sequences (all 25: "
          f"24.5 s); query -o fasta through the archive over the first "
          f"{TB_AGZ_WINDOWS} of the 64 windows (all: 10.2 s)", flush=True)
    spent = 0.0

    def sizes(paths):
        return "in_bytes=" + "+".join(str(os.path.getsize(p)) for p in paths)

    # Post-processing: each output spells its input's paths.
    for cmd, extra in (("normalize", []), ("normalize-self-loops", []),
                       ("smooth", []), ("crush", [])):
        runs = []
        for i, g in enumerate(gfas):
            out = os.path.join(tmp, f"tb_{cmd}_{i}.gfa")
            runs.append(toolbox_run(kernels, [cmd, g, *extra, "--output",
                                              out], out=out))
            with open(g) as fh:
                truth = spell_gfa(fh.read())
            _spells(cmd, runs[-1]["data"].decode(), truth)
        spent += toolbox_line(cmd, runs, sizes(gfas),
                              extra="spelled_exactly=True")
    runs = [toolbox_run(kernels, ["normalize-self-loops", g, "--diagnose"])
            for g in gfas]
    diag = [json.loads(r["data"]) for r in runs]
    spent += toolbox_line("normalize-self-loops --diagnose", runs,
                          sizes(gfas), extra="direct_self_loop_edges="
                          + json.dumps([d["direct_self_loop_edges"]
                                        for d in diag]))
    runs = [toolbox_run(kernels, ["render-graph", g, "--output",
                                  os.path.join(tmp, f"tb_{i}.svg")],
                        out=os.path.join(tmp, f"tb_{i}.svg"))
            for i, g in enumerate(gfas)]
    if not all(r["data"].startswith(b"<svg") for r in runs):
        raise AssertionError("graph toolbox render-graph: not an SVG")
    spent += toolbox_line("render-graph", runs, sizes(gfas),
                          extra="svg_bytes=" + "+".join(
                              str(len(r["data"])) for r in runs))

    # Calls and reports.
    vcfs = {}
    for sites in ("anchors", "flubbles"):
        runs = [toolbox_run(kernels, ["gfa2vcf", g, "--sites", sites])
                for g in gfas]
        vcfs[sites] = [r["data"].decode() for r in runs]
        recs = [sum(1 for ln in v.splitlines() if not ln.startswith("#"))
                for v in vcfs[sites]]
        spent += toolbox_line(f"gfa2vcf --sites {sites}", runs, sizes(gfas),
                              extra=f"records={recs}")
    for i, g in enumerate(gfas):
        with open(g) as fh:
            text = fh.read()
        rep = gfa_columns.report_columns(gfa_columns.parse_gfa_columns(text))
        if rep != gfa_mod.report(gfa_mod.Gfa.parse(text)):
            raise AssertionError(f"graph toolbox: report_columns differs "
                                 f"from report on window {i}")
    for fmt in TB_REPORT_FORMATS:
        runs = [toolbox_run(kernels, ["graph-report", g, "--format", fmt])
                for g in gfas]
        if fmt == "json":
            nodes = [json.loads(r["data"])["nodes"] for r in runs]
        spent += toolbox_line(f"graph-report --format {fmt}", runs,
                              sizes(gfas), extra="report_columns_equal_"
                              "report=True")
    runs = [toolbox_run(kernels, ["graph-report", g, "--flubbles"])
            for g in gfas]
    spent += toolbox_line("graph-report --flubbles", runs, sizes(gfas),
                          extra=f"nodes={nodes}")

    # Lace: the windows' graphs, gaps filled from the panel, and the
    # windows' VCFs lifted back to the genome frame.
    out = os.path.join(tmp, "tb_laced.gfa")
    r = toolbox_run(kernels, ["lace", "--gfa-files", ",".join(gfas),
                              "--fill-gaps", "--sequence-files", fa,
                              "--output", out], out=out)
    n = _laced_spells(r["data"].decode(), gfas, panel)
    spent += toolbox_line("lace --fill-gaps", [r], sizes(gfas),
                          extra=f"laced_paths={n} spelled_exactly=True")
    vpaths = []
    for i, ((s, e), v) in enumerate(zip(wins, vcfs["anchors"])):
        vpaths.append(os.path.join(tmp, f"tb_w{i}.vcf"))
        with open(vpaths[-1], "w") as fh:
            fh.write(_window_vcf(v, s, e))
    out = os.path.join(tmp, "tb_laced.vcf")
    r = toolbox_run(kernels, ["lace", "--files", ",".join(vpaths),
                              "--output", out], out=out)
    got, want = (_vcf_records(r["data"].decode()),
                 [x for v in vcfs["anchors"] for x in _vcf_records(v)])
    if got != want:
        raise AssertionError("graph toolbox lace of VCFs: the records are "
                             "not the windows' records in the genome frame")
    spent += toolbox_line("lace (VCF)", [r], sizes(vpaths),
                          extra=f"records={len(got)} lifted_exactly=True")

    # The cut panel: alignment, a job list and whole-input graphs.
    aln = os.path.join(tmp, "tb_align.paf")
    r = toolbox_run(kernels, ["align", "-f", cut_fa, "-o", aln], out=aln)
    rows = r["data"].decode().splitlines()
    spent += toolbox_line("align", [r], sizes([cut_fa]),
                          extra=f"rows={len(rows)}")
    jobs = os.path.join(tmp, "tb_jobs.txt")
    r1 = toolbox_run(kernels, ["align", "-f", cut_fa, "--job-list", "-o",
                               jobs], out=jobs)
    lines = r1["data"].decode().splitlines()
    head = os.path.join(tmp, "tb_jobs_head.txt")
    with open(head, "w") as fh:
        for i, ln in enumerate(lines[:TB_JOBS]):
            if not ln.startswith("python -m impg_tpu_torch.cli align "):
                raise AssertionError(f"graph toolbox: job line {ln!r}")
            fh.write(ln.replace("python -m", f"{sys.executable} -m", 1)
                     .replace(f"-o pair_{i:05d}.paf",
                              f"-o {tmp}/pair_{i:05d}.paf") + "\n")
    saved = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = REPO + (os.pathsep + saved if saved else "")
    try:
        r2 = toolbox_run(kernels, ["align", "-f", cut_fa, "--run-joblist",
                                   head, "--jobs", str(TB_JOBS)])
    finally:
        if saved is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = saved
    for i, ln in enumerate(lines[:TB_JOBS]):
        q, t = ln.split("--pair ")[1].split()[0].split(":")
        pair_rows = [x for x in rows if x.split("\t")[0] == q
                     and x.split("\t")[5] == t]
        if _read(f"{tmp}/pair_{i:05d}.paf").decode().splitlines() != \
                pair_rows:
            raise AssertionError(f"graph toolbox run-joblist: pair {q}:{t} "
                                 "differs from align's rows")
    spent += toolbox_line("align --job-list, --run-joblist", [r1, r2],
                          sizes([cut_fa]), extra=f"jobs={len(lines)} "
                          f"ran={TB_JOBS} pair_files_equal_align=True")
    graphs = {}
    poa_fa = os.path.join(tmp, "tb_cut_head.fa")
    synth.write_fasta(poa_fa, [(k, v) for k, v in cut.items()][:TB_POA_SEQS])
    for label, gfa_fa, argv in (
            (f"poa (first {TB_POA_SEQS} sequences)", poa_fa,
             ["--gfa-engine", "poa"]),
            ("seqwish", cut_fa, ["--gfa-engine", "seqwish"]),
            ("seqwish -a align.paf", cut_fa,
             ["--gfa-engine", "seqwish", "-a", aln]),
            ("pggb", cut_fa, ["--gfa-engine", "pggb"]),
            (f"--partition-size {TB_PARTITION_SIZE}", cut_fa,
             ["--partition-size", str(TB_PARTITION_SIZE)])):
        out = os.path.join(tmp, f"tb_graph_{len(graphs)}.gfa")
        r = toolbox_run(kernels, ["graph", "-f", gfa_fa, *argv, "-o", out],
                        out=out)
        text = r["data"].decode()
        graphs[label] = text
        truth = (_slices(cut, spell_gfa(text)) if "partition" in label
                 else cut)
        n = _spells(f"graph {label}", text, truth)
        same = ""
        if label == "seqwish -a align.paf":
            if text != graphs["seqwish"]:
                raise AssertionError("graph toolbox: graph -a align.paf "
                                     "differs from graph aligning itself")
            same = "equal_self_aligned=True "
        spent += toolbox_line(f"graph {label}", [r], sizes([gfa_fa]),
                              extra=f"paths={n} spelled_exactly=True {same}")

    # The panel through an archive.
    agz = os.path.join(tmp, "tb_panel.agz")
    r = toolbox_run(kernels, ["agz", "create", fa, "-o", agz])
    arc = agz_mod.AgzArchive(agz)
    try:
        for name, s in panel.items():
            if arc.fetch_sequence(name, 0, len(s)) != s:
                raise AssertionError(f"graph toolbox agz: {name} differs "
                                     "from the FASTA")
    finally:
        arc.close()
    r2 = toolbox_run(kernels, ["agz", "list", agz])
    listed = [ln.split("\t") for ln in r2["data"].decode().splitlines()]
    if sorted((c, int(n)) for _, c, n in listed) != sorted(
            (k, len(v)) for k, v in panel.items()):
        raise AssertionError("graph toolbox agz list: contigs or lengths "
                             "differ from the FASTA")
    spent += toolbox_line("agz create, list", [r, r2], sizes([fa]),
                          extra=f"archive_bytes={os.path.getsize(agz)} "
                          "round_trip_equal=True")
    bed = _bed(os.path.join(tmp, "tb_fasta.bed"),
               seq["fasta_windows"][:TB_AGZ_WINDOWS])
    walk = ["query", "-a", paf, "-b", bed, "-x", "-m", "2", "-d", "0",
            "-o", "fasta"]
    r = toolbox_run(kernels, walk + ["--sequence-files", agz], "device")
    ref = toolbox_run(kernels, walk + ["--sequence-files", fa], "device")
    if r["data"] != ref["data"] or not r["data"]:
        raise AssertionError("graph toolbox: query -o fasta through the "
                             "archive differs from the FASTA's")
    spent += toolbox_line("query -o fasta --sequence-files panel.agz", [r],
                          f"windows={TB_AGZ_WINDOWS}", WALK_PATH,
                          extra=f"out_bytes={len(r['data'])} "
                          f"equal_fasta_backed=True fasta_backed_wall_s="
                          f"{ref['wall']:.3f}")

    # Render bundles of one 2 kb window: of the panel with POA, of the cut
    # panel with pggb.
    for engine, (rfa, rpaf), (s, e) in (
            ("poa", (fa, paf), wins[0]),
            ("pggb", seq["cut"], GP_CUT_WINDOWS[1])):
        prefix = os.path.join(tmp, f"tb_render_{engine}")
        r = toolbox_run(kernels, ["render", "-a", rpaf, "-r",
                                  f"base:{s}-{e}", "-d", "0", "-x", "-m",
                                  "2", "--sequence-files", rfa, "-O", prefix,
                                  "--gfa-engine", engine, "--render-graph"])
        with open(os.path.join(prefix, "manifest.json")) as fh:
            manifest = json.load(fh)
        named = set(manifest["files"].values()) | {"manifest.json",
                                                   "render.svg"}
        if named != set(os.listdir(prefix)):
            raise AssertionError(f"graph toolbox render {engine}: the "
                                 "bundle holds files its manifest does not "
                                 "name, or lacks one")
        rendered = _fasta_dict(os.path.join(prefix, "render.fa"))
        n = _spells(f"render {engine}",
                    _read(os.path.join(prefix, "render.gfa")).decode(),
                    rendered)
        spent += toolbox_line(f"render -x --gfa-engine {engine} "
                              "--render-graph", [r], f"base:{s}-{e} of "
                              f"{os.path.basename(rfa)}",
                              extra=f"paths={n} step_samples="
                              f"{manifest['step_samples']} "
                              "manifest_names_every_file=True")
    phase_s = time.perf_counter() - t_phase
    print(f"[4 graph toolbox] phase_s={phase_s:.1f} commands_s={spent:.1f}",
          flush=True)
    return phase_s


def toolbox_sort_graph(tmp: str, text: str, gc, kernels, reads: str) -> float:
    """`graph-report` of the [4 sort] graph (the columnar report; its
    counts equal the columns' in memory: report_columns equals report on
    the region graphs of `phase_graph_toolbox`); then `map --graph -o gaf` of
    the first TB_PROJECT_READS of [4 genotype graph]'s reads onto the graph
    cut to the paths TB_PROJECT_PATHS (the truth pair's among them) and
    `project` of that GAF onto it (every record retained, a pack row a
    segment touched).  Returns the seconds."""
    from impg_tpu_torch.graph import gfa_columns

    t0 = time.perf_counter()
    gfa = os.path.join(tmp, "tb_sort.gfa")
    with open(gfa, "w") as fh:
        fh.write(text)
    r = toolbox_run(kernels, ["graph-report", gfa, "--format", "json"])
    rep = json.loads(r["data"])
    counts = dict(nodes=gc.n_segs, edges=int(gc.link_a.size),
                  paths=gc.n_paths,
                  total_segment_bp=int(gc.seg_lens().sum()))
    if {k: rep[k] for k in counts} != counts:
        raise AssertionError("graph toolbox graph-report: the [4 sort] "
                             "graph's counts differ from its columns'")
    spent = toolbox_line("graph-report ([4 sort] graph)", [r],
                         f"segments={gc.n_segs} steps="
                         f"{gc.step_name_idx.size} in_bytes={len(text)}",
                         extra="counts_equal_columns=True")
    keep = set(TB_PROJECT_PATHS)
    cut = os.path.join(tmp, "tb_sort_cut.gfa")
    with open(cut, "w") as fh:
        for ln in text.splitlines(keepends=True):
            if not ln.startswith("P\t") or ln.split("\t", 2)[1] in keep:
                fh.write(ln)
    head = os.path.join(tmp, "tb_reads.fq")
    with open(reads, "rb") as src, open(head, "wb") as dst:
        for _ in range(4 * TB_PROJECT_READS):
            dst.write(src.readline())
    size = (f"segments={gc.n_segs} paths={len(keep)} in_bytes="
            f"{os.path.getsize(cut)}")
    print(f"[setup] graph toolbox: map --graph and project on the [4 sort] "
          f"graph's paths {','.join(TB_PROJECT_PATHS)} and "
          f"{TB_PROJECT_READS} of [4 genotype graph]'s reads; reduced: on "
          f"all 90 paths project's graph fingerprint (a per-byte hash over "
          f"every step, as impg_tpu's) and the dict-model parse took 43.7 "
          f"of 49.9 s and map --graph 30.7 s on an H100 host (on 17 paths "
          f"15.6 and 10.9 s)", flush=True)
    gaf = os.path.join(tmp, "tb_sort.gaf")
    r = toolbox_run(kernels, ["map", "--graph", cut, "-q", head, "-o", "gaf",
                              "-O", gaf], out=gaf)
    n_gaf = r["data"].count(b"\n")
    spent += toolbox_line("map --graph -o gaf ([4 sort] graph, cut)", [r],
                          f"{size} reads={TB_PROJECT_READS}",
                          extra=f"gaf_records={n_gaf}")
    proj = os.path.join(tmp, "tb_sort.proj")
    r = toolbox_run(kernels, ["project", "--gfa", cut, "--gaf", gaf, "-O",
                              proj])
    done = r["stderr"].split("Projected ")[1].split(" GAF")[0]
    pack = _read(os.path.join(proj, "sample.pack.tsv")).decode().splitlines()
    n_rows = sum(1 for ln in pack if not ln.startswith("#"))
    if done != f"{n_gaf}/{n_gaf}" or n_rows == 0:
        raise AssertionError(f"graph toolbox project: {done} records "
                             f"retained, {n_rows} pack rows")
    spent += toolbox_line("project ([4 sort] graph, cut)", [r], size,
                          extra=f"records={done} pack_rows={n_rows}")
    wall = time.perf_counter() - t0
    print(f"[4 graph toolbox] [4 sort] graph part: {wall:.1f}s "
          f"(commands {spent:.1f}s)", flush=True)
    return wall

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
    from impg_tpu_torch.commands import partition as part_mod
    from impg_tpu_torch.commands import refine as refine_mod
    from impg_tpu_torch.query import engine as engine_mod
    from impg_tpu_torch.genotype import graph as gt_graph
    from impg_tpu_torch.graph import gfa as gfa_mod

    t_start = time.perf_counter()
    dev_info = phase_device()
    phase_build(kernels)
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError("the port's native host library did not load")
    # The aligner and seqwish's union-find and emitter: without them the
    # region graphs would fall back to Python.
    absent = [sym for sym in ("impg_align_pair", "impg_align_prefix",
                              "uf_union_runs", "uf_find_all",
                              "impg_seqwish_emit")
              if not hasattr(native.load(), sym)]
    if absent:
        raise AssertionError(f"the native host library lacks {absent}")
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

    step_us = windows_load_latency_us(D)
    print(f"[3 kernels] windows search step: {step_us:.4f} us (one query, "
          "2^24 against 1 records, in turns)", flush=True)
    rows, front = phase_kernels(eng, index, targets, D, SC, host, step_us)
    launches, native_rows = phase_slice(eng, index, targets, kernels, D, host,
                                        lean_bytes)
    phase_profile(eng, index, targets, host)
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        part_rows, _ = phase_partition(eng, index, kernels, D, host, part_mod,
                                       engine_mod, tmp, step_us)
        rows.update(part_rows)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_refine(eng, index, targets, kernels, host, refine_mod, engine_mod)
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
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        graph_rows, graph_launches = phase_genotype_graph(
            text, gc, kernels, co, gt_graph, gt_core, gfa_mod, OD, synth,
            tmp)
        toolbox_s = toolbox_sort_graph(tmp, text, gc, kernels,
                                       os.path.join(tmp, "graph_reads.fq"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows.update(graph_rows)
    launches["diploid"] += graph_launches["diploid"]
    del text, gc, sort_inputs
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="impg_smoke_")
    try:
        seq = phase_sequence(tmp, kernels, synth)
        syngt, pipeline = phase_graph_pipeline(tmp, kernels, seq)
        phase_tracepoint_files(tmp, kernels, synth, seq, syngt)
        phase_syng_tools(tmp, kernels, synth, seq, syngt)
        toolbox_s += phase_graph_toolbox(tmp, kernels, synth, seq, pipeline)
        print(f"[4 graph toolbox] total_s={toolbox_s:.1f} budget_s="
              f"{TB_BUDGET_S} within_budget={toolbox_s <= TB_BUDGET_S}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    # The card again, so that the end of the output names it.
    print(dev_info["smi"], flush=True)

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
