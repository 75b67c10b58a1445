"""Command line of the PyTorch/CUDA port.

The port's own CLI for every subcommand of impg_tpu.cli: `index`, `query`,
`stats`, `partition`, `refine`, `similarity`, `syng`, `map`, `genotype`,
`sort`, `export-1aln`, `export-tpa`, `read-index`, `syng2gfa`,
`syng-repair`, `infer` and the GFA toolbox (`graph`, `align`, `lace`,
`render`, `project`, `normalize`, `normalize-self-loops`, `smooth`,
`crush`, `gfa2vcf`, `graph-report`, `render-graph`, `agz`), with
impg_tpu.cli's argument names, defaults, messages and output bytes for them;
it imports nothing of impg_tpu.  Alignments are PAF (optionally gzipped),
`.1aln` (ASCII or the ONEcode binary container) or `.tpa`: tracepoint files
are ingested on the host, approximately, or exactly with `--sequence-files`
(io/onealn.py, io/tpa.py), and the index they give is walked like a PAF
index.  `--compute-engine device|auto` runs the port's engines
(for `partition` and `refine -x`, one transitive walk a window or flank
candidate; for `similarity -x`, one a target):

  * `TorchDeviceEngine`, resident on the card; built with tracepoints (and
    no CIGAR arena) for `--approximate` walks, which then run on the card
    too unless even those columns pass the device budget;
  * `TorchPagedEngine` (query/paged.py) for exact walks and `stats -r/-b`
    over an index whose lean bytes pass the device budget or whose arena
    passes 2^31 runs;
  * `--compute-engine mesh`: `ShardedEngine` (parallel/sharding.py), the
    index cut into record blocks over every visible GPU (over `[device]`
    on the CPU), never paged, built with tracepoints for `--approximate`;
    `stats -r/-b` then counts on the host, and `syng`, `map` and
    `genotype` take it for `device`.  With IMPG_COORDINATOR=host:port,
    IMPG_NUM_PROCESSES and IMPG_PROCESS_ID set, one process a rank joins a
    torch.distributed group first and the mesh spans every rank's GPUs
    (parallel/distributed.py: DistributedEngine); only rank 0's `query`
    writes output;
  * the syncmer kernels: `syng --compute-engine device` extracts with K-F,
    `map --compute-engine device` maps reads with K-G (`auto` keeps both on
    the host, as impg_tpu.cli does), and `genotype cos|cosigt` scores
    ploidy-2 pairs with the cuBLAS Gram and K-H (device: always; auto: past
    the FLOP crossover of genotype/core.auto_device_for_dense), with the
    syng backend's packs or, with `--graph`, over a GFA's segments
    (genotype/graph.py: reads mapped to the path walks on the host, or one
    pack, IMPGPKB1 or `#node_id\tcount` TSV);
  * `sort --sgd-backend device` (alias `jax`) lays the graph out with the
    path-SGD kernel K-I; `auto` does so past impg_tpu's volume threshold of
    5e8 samples when CUDA is available, else runs the numpy loop, which
    writes impg_tpu's bytes.

On the host, as in impg_tpu: `map -a INDEX -o gaf|paf|proj` (syng/map.py),
`map --graph GFA -o graph-pack|graph-pack-tsv|gaf|paf`, and `query -a
X.syngt`, raw or chained with `-x` (syng/transitive.py; with sequence files
the chain ends refine by native ends-free alignment), to bed, bedpe, gbwt
and every region format; the sequence stages of `query -o
fasta|fasta+paf|gfa|maf|fasta-aln|vcf|gbwt` (gbwt: the walk's merged
intervals indexed as a regional `.syngt` with the native extractor),
`partition -o fasta|gfa|maf|vcf` and `similarity` after their walks
(sequences through io/fasta.py's UnifiedSequenceIndex, graphs and MSAs
through the C++ POA of graph/poa.py); the region graph engines
`--gfa-engine seqwish|syng-native|pggb` of `-o gfa|vcf` (all-vs-all
alignment, seqwish induction and pggb's chain, graph/region.py); the `-o
gfa:<pipeline>` stages after any engine (`cut-n`, `sort`, `sgd`, `smooth`,
`normalize`, `crush`, `selfloops`); the tracepoint exports; and the syng
tools: `read-index`, `syng2gfa`, `syng-repair` and `infer` (candidates
scored by genotype_cos on the host, as impg_tpu's infer does whatever
`--compute-engine` says; `--gaf` read walks matched through the GBWT of
syng/gbwt.py); and the GFA toolbox: whole-input graphs (`graph --gfa-engine
poa|seqwish|pggb`, with a given PAF, `--sparsify`, or `--partition-size`
through this CLI's own `partition -o gfa` on the same device), all-vs-all
alignment (`align`, job lists whose commands run this package's CLI, where
impg_tpu's run impg_tpu.cli), lacing of GFAs and VCFs (`lace`; a `.zst`
output needs `zstandard`, imported when it is written), the post-processing
commands over graph/ (`normalize`, `normalize-self-loops`, `smooth`,
`crush`), variant calls and reports (`gfa2vcf`, `graph-report` on the GFA
columns), render bundles (`render`, its walk on the host engine as in
impg_tpu.cli), `render-graph`, `project` and `agz create|list`.  `graph
--gfa-engine` does not offer `syng-local`, which impg_tpu.cli accepts and
then always refuses: both exit 2.

    python -m impg_tpu_torch.cli query -a aln.paf -r 'chr1:0-50000' -x \\
        -d 100 -o bed --compute-engine device

From the command line the device is always `cuda:0`.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from impg_tpu_torch import tracing
from impg_tpu_torch.io import bed as bed_mod

# Sequence-backed region formats of `query` (`gfa:<pipeline>` is gfa).
REGION_FORMATS = ("fasta", "gfa", "maf", "fasta-aln", "vcf")
# Post-processing stages of `-o gfa:<pipeline>` on the PAF-index route.
GFA_STAGES = ("sort", "sgd", "smooth", "normalize", "crush", "selfloops",
              "self-loops", "cut-n")


def _fail(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _read_gfa(path: str) -> str:
    """A GFA's text from `path`, or from stdin for `-`."""
    if path == "-":
        return sys.stdin.read()
    with open(path) as fh:
        return fh.read()


def _write_out(path, text: str) -> None:
    """`text` into `path`, or onto stdout when no path is given."""
    if path:
        with open(path, "w") as fh:
            fh.write(text)
    else:
        sys.stdout.write(text)


def _poa_scoring(spec: str) -> tuple:
    """`--poa-scoring` values, comma- or slash-separated."""
    return tuple(int(x) for x in spec.replace("/", ",").split(","))


def _add_engine_opt(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--compute-engine",
        choices=["host", "native", "device", "mesh", "auto"],
        default="auto",
        help="host: numpy engine; native: C++ transitive-BFS engine "
        "(default filter set only); device: the CUDA engine on cuda:0 "
        "(paged past the device budget); mesh: sharded engine over every "
        "visible GPU (multi-process with IMPG_COORDINATOR); auto "
        "(default): the C++ engine for default-filter transitive queries, "
        "else device/mesh when CUDA is available and the index is non-toy, "
        "else host (IMPG_AUTO_MIN_RECORDS tunes the gate)",
    )


def _add_common_query_opts(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-a",
        "--alignment",
        required=True,
        action="append",
        help="Alignment file(s) (PAF, optionally bgzip/gzip-compressed); "
        "repeat or comma-separate for multiple",
    )
    p.add_argument("--index", help="Index artifact path (default: <aln>.impgt)")
    p.add_argument(
        "-I",
        "--force-reindex",
        action="store_true",
        help="Rebuild the index even if a fresh artifact exists",
    )
    p.add_argument(
        "--no-bidirectional",
        action="store_true",
        help="Only index alignments in their stated direction",
    )


def _alignment_files(args) -> list[str]:
    files: list[str] = []
    for entry in args.alignment:
        files.extend(x for x in entry.split(",") if x)
    return files


def _load_index(args):
    from impg_tpu_torch.index import impg_index

    files = _alignment_files(args)
    seq_fetch = None
    if any(f.endswith((".1aln", ".tpa")) for f in files) and getattr(
        args, "sequence_files", None
    ):
        # .1aln/.tpa tracepoint ingest: sequences enable exact per-segment
        # CIGAR reconstruction with the native aligner.
        seq_fetch = _sequence_index(args).fetch_sequence
    if args.no_bidirectional:
        # Bypass cache for non-default build flavor.
        return impg_index.ImpgIndex.from_paf_files(
            files, bidirectional=False, seq_fetch=seq_fetch
        )
    return impg_index.load_or_build(
        files, args.index, force=args.force_reindex, seq_fetch=seq_fetch,
        threads=getattr(args, "threads", 1),
    )


def cmd_index(args) -> int:
    from impg_tpu_torch.index import impg_index

    files = _alignment_files(args)
    if args.index is None and len(files) > 1 and not args.no_bidirectional:
        # Per-file artifacts (multi_impg.rs role): each file caches its own
        # index; queries merge them in memory.
        idx = impg_index.load_or_build(files, force=True)
        paths = ", ".join(f + impg_index.INDEX_SUFFIX for f in files)
        print(
            f"Indexed {len(idx.records)} directed records over "
            f"{len(idx.seq_index)} sequences -> per-file artifacts "
            f"({paths})",
            file=sys.stderr,
        )
        return 0
    idx = impg_index.ImpgIndex.from_paf_files(
        files, bidirectional=not args.no_bidirectional
    )
    path = args.index or impg_index.index_path_for(files)
    idx.save(path)
    print(
        f"Indexed {len(idx.records)} directed records over "
        f"{len(idx.seq_index)} sequences -> {path}",
        file=sys.stderr,
    )
    return 0


def _sequence_index(args):
    """The UnifiedSequenceIndex over `--sequence-files` (or the list file's
    paths, which main() put there)."""
    from impg_tpu_torch.io.fasta import UnifiedSequenceIndex

    return UnifiedSequenceIndex.from_files(_comma_list(args.sequence_files))


def _clip_terminal_n_runs(index, results, seq_idx, min_run: int):
    """Clip each result interval's terminal N-runs of >= min_run bases
    against the real sequence; drop intervals left empty
    (graph.rs:69 terminal_n_clip_span / :93 clip_intervals_terminal_n_runs).
    """
    import dataclasses

    def is_n(b):
        return b in (78, 110)  # 'N' / 'n'

    out = []
    kept_bp = 0
    before_bp = 0
    for r in results:
        lo, hi = (
            (r.q_first, r.q_last) if r.q_first <= r.q_last
            else (r.q_last, r.q_first)
        )
        before_bp += hi - lo
        if hi <= lo:
            continue
        if min_run <= 0:
            out.append(r)
            kept_bp += hi - lo
            continue
        name = index.seq_index.get_name(r.q_id)
        seq = seq_idx.fetch_sequence(name, lo, hi)
        pre = 0
        while pre < len(seq) and is_n(seq[pre]):
            pre += 1
        suf = 0
        while suf < len(seq) - pre and is_n(seq[len(seq) - 1 - suf]):
            suf += 1
        start = lo + (pre if pre >= min_run else 0)
        end = hi - (suf if suf >= min_run else 0)
        if start >= end:
            continue
        kept_bp += end - start
        if (start, end) == (lo, hi):
            out.append(r)
        elif r.q_first <= r.q_last:
            out.append(dataclasses.replace(r, q_first=start, q_last=end))
        else:
            out.append(dataclasses.replace(r, q_first=end, q_last=start))
    print(
        f"terminal N clipping: min-run={min_run} kept {len(out)} / "
        f"{len(results)} interval(s), {before_bp} -> {kept_bp} bp",
        file=sys.stderr,
    )
    return out


def _gfa_pipeline_stages(fmt: str):
    """The stages after `gfa` of an `-o gfa:<pipeline>` spec, or None (the
    error printed) when the spec does not parse."""
    from impg_tpu_torch.graph.pipeline import GraphPipelineSpec

    try:
        return GraphPipelineSpec.parse(fmt).stages[1:]
    except ValueError as e:
        print(f"error: invalid -o pipeline spec: {e}", file=sys.stderr)
        return None


def _emit_region_format(
    index, results, out, fmt, args, seq_idx, gfa_stages, target_id,
    merge_distance,
) -> None:
    """Sequence-backed region outputs (fasta/gfa/maf/fasta-aln/vcf) shared
    by the PAF-index and syng query routes (the reference routes both
    through the same realignment path, main.rs:6668)."""
    from impg_tpu_torch.query import outputs

    if fmt == "fasta":
        # FASTA keeps strands separate (main.rs:4395 default, and
        # --consider-strandness also keeps them separate).
        outputs.write_fasta(
            index.seq_index,
            results,
            out,
            seq_idx,
            merge_distance,
            False,
            args.reverse_complement,
        )
        return
    from impg_tpu_torch.graph import region as region_mod
    from impg_tpu_torch.query import merge as merge_mod

    scoring = _poa_scoring(args.poa_scoring)
    # cut-n=N is a PRE-engine stage: clip each gathered interval's terminal
    # N-runs (>= N bases) against the real sequence before the GFA engine
    # runs (lib.rs:963-979 terminal_n_clip; graph.rs:69 terminal_n_clip_span).
    cut_stage = next((s for s in gfa_stages if s.name == "cut-n"), None)
    if cut_stage is not None:
        min_run = int(cut_stage.param("min-run") or cut_stage.value or 100)
        results = _clip_terminal_n_runs(
            index, results, seq_idx, min_run
        )
        gfa_stages = [s for s in gfa_stages if s.name != "cut-n"]
    # gfa/maf merge strands by default; fasta-aln keeps them separate
    # (main.rs:4395-4399).
    ms = not (fmt == "fasta-aln" or args.consider_strandness)
    merge_mod.merge_query_adjusted_intervals(results, merge_distance, ms)
    build_fmt = "gfa" if fmt == "vcf" else fmt
    if build_fmt == "gfa" and args.gfa_engine in (
        "seqwish", "pggb", "syng-native"
    ):
        text = region_mod.generate_gfa_seqwish(
            index, results, seq_idx, engine=args.gfa_engine,
        )
    else:
        gen = {
            "gfa": region_mod.generate_gfa,
            "maf": region_mod.generate_maf,
            "fasta-aln": region_mod.generate_fasta_aln,
        }[build_fmt]
        text = gen(index, results, seq_idx, scoring)
    if fmt == "vcf":
        from impg_tpu_torch.graph import vcf as vcf_mod

        text = vcf_mod.gfa_to_vcf(text, index.seq_index.get_name(target_id))
    if gfa_stages:
        from impg_tpu_torch.graph import gfa as gfa_mod

        for stage in gfa_stages:
            if stage.name == "sort":
                text = gfa_mod.topological_sort(
                    gfa_mod.Gfa.parse(text)
                ).write()
            elif stage.name == "sgd":
                from impg_tpu_torch.graph import sortgfa as sortgfa_mod

                text = sortgfa_mod.sort_pipeline(
                    text, stage.param("pipeline") or "Ygs"
                )
            elif stage.name == "smooth":
                from impg_tpu_torch.graph import smooth as smooth_mod

                bl = int(stage.param("block-len") or 1100)
                text = smooth_mod.smooth_gfa(
                    text, bl,
                    block_source=stage.param("block-source") or "fixed",
                )
            elif stage.name == "normalize":
                from impg_tpu_torch.graph import normalize as norm_mod

                text = norm_mod.normalize_gfa(text)
            elif stage.name == "crush":
                from impg_tpu_torch.graph import crush as crush_mod

                max_span = int(stage.param("max-span") or 10_000)
                text, cst = crush_mod.crush_gfa(text, max_span=max_span)
                print(
                    f"crush: {cst.bubbles_resolved} resolved across "
                    f"{cst.rounds} rounds, {cst.bp_before} -> "
                    f"{cst.bp_after} bp",
                    file=sys.stderr,
                )
            elif stage.name in ("selfloops", "self-loops"):
                from impg_tpu_torch.graph import selfloops as sl_mod

                max_unit = int(stage.param("max-unit-len") or 0)
                text, _sl = sl_mod.normalize_self_loops(text, max_unit)
    out.write(text)


def _original_length_lookup(args):
    """Original-frame sequence lengths for `--original-sequence-coordinates`
    PAF output (main.rs:4681 get_original_sequence_length: external
    sequence index when available, else 0 with a warning)."""
    if not getattr(args, "original_sequence_coordinates", False):
        return None
    seq_idx = None
    if _comma_list(getattr(args, "sequence_files", None)):
        seq_idx = _sequence_index(args)

    def lookup(name: str) -> int:
        if seq_idx is None:
            print(
                f"warning: no sequence index provided, using 0 as length "
                f"for sequence '{name}'",
                file=sys.stderr,
            )
            return 0
        try:
            return seq_idx.get_sequence_length(name)
        except (KeyError, ValueError):
            print(
                f"warning: sequence '{name}' not found in sequence index, "
                f"using 0 as length",
                file=sys.stderr,
            )
            return 0

    return lookup


# Share of the card's free memory that the device budget takes: the JAX
# default's share of its chip (12 GiB of a 16 GiB v5e).
CUDA_BUDGET_SHARE = 0.75


def device_budget(device: torch.device) -> int:
    """Bytes the device engines may hold: IMPG_HBM_BUDGET_BYTES when set;
    else, on CUDA, CUDA_BUDGET_SHARE (3/4) of the free memory that
    `torch.cuda.mem_get_info` reports; else the JAX default of 12 GiB."""
    env = os.environ.get("IMPG_HBM_BUDGET_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * CUDA_BUDGET_SHARE)
    from impg_tpu_torch.query.paged import DEFAULT_BUDGET

    return DEFAULT_BUDGET


def resolve_compute_engine(args, index, approximate: bool = False,
                           n_targets: int = 0, native_ok: bool = False, *,
                           device: torch.device):
    """--compute-engine host|native|device|auto|mesh onto an engine, with
    impg_tpu.cli._resolve_compute_engine's contract.

    host -> None (numpy engine).  native -> the C++ BFS engine (default
    filter set only).  device -> on `device` (exits 2 when it names CUDA and
    CUDA is absent): an approximate walk gets TorchDeviceEngine with
    tracepoints, which uploads no CIGAR arena, unless its bytes
    (n_boundaries * 12 + n_records * 48) pass `device_budget` or its
    tracepoint table has 2^31 boundaries, and then the host (no device
    engine pages tracepoints).  Any other command whose lean index bytes
    (n_ops * 20 + n_records * 36) pass `device_budget`, or whose arena has
    2^31 runs or more, gets the paged TorchPagedEngine under that budget;
    else TorchDeviceEngine.  mesh -> ShardedEngine over every visible GPU
    (over `[device]` on the CPU; exits 2 as device does without CUDA), built
    with tracepoints for approximate walks and never paged; with
    IMPG_COORDINATOR set, the process joins the group first
    (parallel/distributed.initialize) and gets DistributedEngine.  auto ->
    native for default-filter walks, else, when `device` is a usable CUDA
    device and the index passes the IMPG_AUTO_MIN_RECORDS gate, mesh if
    more than one GPU is visible or IMPG_COORDINATOR is set, else device;
    else host.
    """
    spec = getattr(args, "compute_engine", "host") or "host"
    if spec == "host":
        return None
    if spec in ("native", "auto") and native_ok:
        from impg_tpu_torch.query.host_native import NativeHostEngine

        try:
            return NativeHostEngine(index)
        except RuntimeError:
            if spec == "native":
                _fail("--compute-engine native requires the native library "
                      "(g++ build of impg_tpu_torch/native/)")
    elif spec == "native":
        _fail("--compute-engine native does not produce CIGAR-bearing output "
              "(paf/bedpe/fasta+paf); use host/device/mesh")
    # The group is joined before any engine touches a device.
    want_dist = spec in ("mesh", "auto") and bool(
        os.environ.get("IMPG_COORDINATOR"))
    if want_dist:
        from impg_tpu_torch.parallel import distributed

        if not distributed.dist.is_initialized():
            distributed.initialize()
    cuda = device.type == "cuda" and torch.cuda.is_available()
    if spec == "auto":
        if not cuda:
            return None
        n_records = len(getattr(index, "records", ())) or n_targets
        min_records = int(os.environ.get("IMPG_AUTO_MIN_RECORDS", "4096"))
        if n_records < min_records and n_targets < 64:
            return None
        spec = "mesh" if torch.cuda.device_count() > 1 or want_dist else (
            "device")
    if device.type == "cuda" and not cuda:
        _fail(f"--compute-engine {spec} needs a CUDA device")
    if spec == "mesh":
        devices = None if device.type == "cuda" else [device]
        if want_dist:
            from impg_tpu_torch.parallel.distributed import DistributedEngine

            return DistributedEngine(index, devices,
                                     with_tracepoints=approximate)
        from impg_tpu_torch.parallel.sharding import ShardedEngine

        return ShardedEngine(index, devices, with_tracepoints=approximate)
    budget = device_budget(device)
    from impg_tpu_torch.query.device import TorchDeviceEngine

    if approximate:
        tp = index.tp if index.tp is not None else index.ensure_tracepoints()
        n_bound = tp.q_bound.size
        if n_bound * 12 + len(index.records) * 48 > budget or n_bound >= 2**31:
            return None
        return TorchDeviceEngine(index, device, with_tracepoints=True)
    n_ops = index.arena.n_ops
    if n_ops * 20 + len(index.records) * 36 > budget or n_ops >= 2**31:
        from impg_tpu_torch.query.paged import TorchPagedEngine

        return TorchPagedEngine(index, device, hbm_budget_bytes=budget)
    return TorchDeviceEngine(index, device)


def _syng_input(files: list[str]) -> bool:
    """One `.syngt` alignment input: a query of the syng backend."""
    return len(files) == 1 and files[0].endswith(".syngt")


def _syng_query(args, merge_distance: int) -> int:
    """Query routing for `-a <prefix>.syngt` (alignment-free backend), on
    the host as in impg_tpu.cli: raw homologous intervals, or with `-x` the
    chained multihop walk, whose chain ends refine by native ends-free
    alignment when sequences are given; bed, bedpe, the region formats
    (`gfa:<pipeline>` included) and gbwt, the regional syng index."""
    from impg_tpu_torch.query import engine as engine_mod
    from impg_tpu_torch.query import outputs
    from impg_tpu_torch.syng.index import SyngIndex

    fmt = args.output_format
    gfa_stages = []
    if fmt.startswith("gfa:"):
        gfa_stages = _gfa_pipeline_stages(fmt)
        if gfa_stages is None:
            return 2
        fmt = "gfa"
    if fmt not in ("bed", "bedpe", "gbwt") + REGION_FORMATS:
        print(
            "error: syng index queries support bed, bedpe, gfa, vcf, "
            "fasta, and gbwt output (main.rs:6602 contract)",
            file=sys.stderr,
        )
        return 2
    seq_idx = None
    if fmt in REGION_FORMATS:
        # Realignment-backed outputs need the sequences (main.rs:6668).
        if not args.sequence_files:
            print(f"error: -o {fmt} requires --sequence-files",
                  file=sys.stderr)
            return 2
        seq_idx = _sequence_index(args)
    gbwt_sequences = None
    if fmt == "gbwt":
        if not args.sequence_files or not args.output:
            print(
                "error: -o gbwt requires --sequence-files and -O PREFIX",
                file=sys.stderr,
            )
            return 2
        gbwt_seq_idx = _sequence_index(args)
        gbwt_sequences = []
    syng = SyngIndex.load(_alignment_files(args)[0])
    if args.target_bed:
        targets = bed_mod.parse_bed_file(args.target_bed)
    else:
        targets = [bed_mod.parse_target_range(args.target_range)]
    # -o gbwt treats -O as an artifact prefix, not a text stream.
    out = (open(args.output, "w") if args.output and fmt != "gbwt"
           else sys.stdout)
    try:
        for target_name, (start, end), name in targets:
            qid = syng.seq_index.get_id(target_name)
            if qid is None:
                print(
                    f"error: sequence '{target_name}' not found in syng index",
                    file=sys.stderr,
                )
                return 1
            if args.transitive:
                # Chained multihop homology walk (syng_transitive.rs role);
                # with --sequence-files, chain ends refine by native
                # ends-free alignment (refine_ends_only role).
                from impg_tpu_torch.syng import transitive as syng_transitive

                if seq_idx is None and args.sequence_files:
                    seq_idx = _sequence_index(args)
                rows = syng_transitive.query_transitive(
                    syng, target_name, start, end,
                    max_depth=args.max_depth,
                    min_transitive_len=args.min_transitive_len,
                    min_distance_between_ranges=(
                        args.min_distance_between_ranges
                    ),
                    seq_idx=seq_idx,
                )
            else:
                intervals = syng.query_region(target_name, start, end)
                # Mirror syng_intervals_to_adjusted (main.rs:11728): homolog
                # interval (reversed coords on '-') + empty CIGAR + query
                # range.
                rows = [
                    engine_mod.Row(qid, start, end, None, qid, start, end)
                ]
                for iv in intervals:
                    hid = syng.seq_index.get_id(iv.genome)
                    if hid is None:
                        continue
                    if iv.strand == "-":
                        rows.append(
                            engine_mod.Row(
                                hid, iv.end, iv.start, None, qid, start, end
                            )
                        )
                    else:
                        rows.append(
                            engine_mod.Row(
                                hid, iv.start, iv.end, None, qid, start, end
                            )
                        )
            if fmt == "bed":
                outputs.write_bed(
                    syng.seq_index, rows, out, name, merge_distance,
                    not args.consider_strandness,
                )
            elif fmt == "gbwt":
                gbwt_sequences.extend(outputs.collect_region_sequences(
                    syng.seq_index, rows, gbwt_seq_idx, merge_distance))
            elif fmt in REGION_FORMATS:
                _emit_region_format(
                    syng, rows, out, fmt, args, seq_idx, gfa_stages, qid,
                    merge_distance,
                )
            else:
                rows.pop(0)
                outputs.write_bedpe(
                    syng.seq_index, rows, out, name, merge_distance
                )
        if gbwt_sequences is not None:
            # Regional index keeps the parent's syncmer parameters
            # (syng.rs:5263 "same syncmer parameters as this index").
            _write_region_gbwt(gbwt_sequences, args.output, k=syng.k,
                               w=syng.w, seed=syng.seed)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def cmd_query(args, device: torch.device) -> int:
    from impg_tpu_torch.query import engine, outputs
    from impg_tpu_torch.query.subset import SubsetFilter

    if args.target_range is None and args.target_bed is None:
        print(
            "error: either --target-range or --target-bed must be provided",
            file=sys.stderr,
        )
        return 2
    if args.merge_distance is None and not args.no_merge:
        print(
            "error: -d/--merge-distance is required (it merges query-gathered "
            "ranges separated by at most D bp). Use --no-merge to disable.",
            file=sys.stderr,
        )
        return 2
    merge_distance = -1 if args.no_merge else bed_mod.parse_size(args.merge_distance)

    # `-a <prefix>.syngt` routes to the alignment-free syng backend
    # (reference: resolve_syng_prefix, main.rs:4634).
    if _syng_input(_alignment_files(args)):
        return _syng_query(args, merge_distance)

    fmt = args.output_format
    gfa_stages = []
    if fmt.startswith("gfa:"):
        gfa_stages = _gfa_pipeline_stages(fmt)
        if gfa_stages is None:
            return 2
        fmt = "gfa"
        for stage in gfa_stages:
            if stage.name not in GFA_STAGES:
                print(
                    f"error: unsupported gfa pipeline stage '{stage.name}' "
                    f"(supported: {', '.join(sorted(GFA_STAGES))})",
                    file=sys.stderr,
                )
                return 2
    valid_formats = {"bed", "bedpe", "paf", "fasta+paf", "gbwt",
                     *REGION_FORMATS}
    if fmt not in valid_formats:
        print(
            f"error: invalid output format '{fmt}' "
            f"(choose from {', '.join(sorted(valid_formats))})",
            file=sys.stderr,
        )
        return 2
    store_cigar = fmt in ("paf", "bedpe", "fasta+paf")

    index = _load_index(args)
    # As in impg_tpu.cli, these checks follow the index load.
    gbwt_sequences = seq_idx = None
    if fmt == "gbwt":
        # Region-specific syng index output (main.rs:4904: requires -O and
        # sequence files); intervals accumulate across all targets.
        if not args.sequence_files or not args.output:
            print(
                "error: -o gbwt requires --sequence-files and -O PREFIX",
                file=sys.stderr,
            )
            return 2
        seq_idx = _sequence_index(args)
        gbwt_sequences = []
    if args.approximate and fmt not in ("bed", "bedpe"):
        print(
            f"error: --approximate mode is only compatible with 'bed' and "
            f"'bedpe' output formats, not '{fmt}'",
            file=sys.stderr,
        )
        return 2

    if args.target_bed:
        targets = bed_mod.parse_bed_file(args.target_bed)
    else:
        targets = [bed_mod.parse_target_range(args.target_range)]

    subset = (
        SubsetFilter.load(args.subset_sequence_list)
        if args.subset_sequence_list
        else None
    )
    subset_match = subset.matches if subset else None

    # -o gbwt treats -O as an artifact prefix, not a text stream.
    out = (open(args.output, "w") if args.output and fmt != "gbwt"
           else sys.stdout)
    merge_strands = not args.consider_strandness  # BED default merges strands

    device_engine = resolve_compute_engine(
        args, index, approximate=args.approximate, n_targets=len(targets),
        # The C++ engine covers exactly the default-filter transitive-BFS
        # walk; any richer ask routes to the device/host engines.
        native_ok=(
            args.transitive and not args.transitive_dfs
            and not store_cigar
        ),
        device=device,
    )
    if device_engine is not None:
        from impg_tpu_torch.parallel.distributed import is_primary

        if not is_primary():
            # Multi-process mesh run: every rank computes the same result;
            # only rank 0 writes it.
            if out is not sys.stdout:
                out.close()
            out = open(os.devnull, "w")

    # Resolve + validate all targets up front (needed for batched walks).
    resolved = []
    for target_name, (start, end), name in targets:
        target_id = index.seq_index.get_id(target_name)
        if target_id is None:
            print(
                f"error: target sequence '{target_name}' not found in index",
                file=sys.stderr,
            )
            return 1
        target_len = index.seq_index.get_len_from_id(target_id)
        if end > target_len:
            print(
                f"error: target range end ({end}) exceeds the target "
                f"sequence length ({target_len})",
                file=sys.stderr,
            )
            return 1
        resolved.append((target_id, start, end, name))

    # Batched multi-walk transitive path: one device batch per depth across
    # all BED rows (the reference loops rows serially, main.rs:7435).
    batched_results = None
    if args.transitive and not args.transitive_dfs and len(resolved) > 1:
        batched_results = engine.query_transitive_bfs_many(
            index,
            [(tid, s, e) for tid, s, e, _ in resolved],
            max_depth=args.max_depth,
            min_transitive_len=args.min_transitive_len,
            min_distance_between_ranges=args.min_distance_between_ranges,
            min_output_length=args.min_output_length,
            store_cigar=store_cigar,
            min_identity=args.min_result_identity,
            subset_match=subset_match,
            device_engine=device_engine,
            approximate=args.approximate,
        )

    try:
        for ti, (target_id, start, end, name) in enumerate(resolved):
            if batched_results is not None:
                results = batched_results[ti]
            elif args.transitive:
                walker = (
                    engine.query_transitive_dfs
                    if args.transitive_dfs
                    else engine.query_transitive_bfs
                )
                kwargs = {}
                if not args.transitive_dfs:
                    kwargs["device_engine"] = device_engine
                    kwargs["approximate"] = args.approximate
                results = walker(
                    index,
                    target_id,
                    start,
                    end,
                    max_depth=args.max_depth,
                    min_transitive_len=args.min_transitive_len,
                    min_distance_between_ranges=args.min_distance_between_ranges,
                    min_output_length=args.min_output_length,
                    store_cigar=store_cigar,
                    min_identity=args.min_result_identity,
                    subset_match=subset_match,
                    **kwargs,
                )
            else:
                results = engine.query(
                    index,
                    target_id,
                    start,
                    end,
                    store_cigar=store_cigar,
                    min_identity=args.min_result_identity,
                    approximate=args.approximate,
                )
                if args.min_output_length is not None:
                    results = [
                        r
                        for r in results
                        if abs(r.q_last - r.q_first) >= args.min_output_length
                    ]
                if subset_match is not None:
                    results = [
                        r
                        for r in results
                        if r.q_id == target_id
                        or (
                            index.seq_index.get_name(r.q_id) is not None
                            and subset_match(index.seq_index.get_name(r.q_id))
                        )
                    ]

            if fmt == "bed":
                outputs.write_bed(
                    index.seq_index,
                    results,
                    out,
                    name,
                    merge_distance,
                    merge_strands,
                    args.original_sequence_coordinates,
                )
            elif fmt == "bedpe":
                results.pop(0)
                outputs.write_bedpe(
                    index.seq_index,
                    results,
                    out,
                    name,
                    merge_distance,
                    args.original_sequence_coordinates,
                )
            elif fmt == "paf":
                results.pop(0)
                outputs.write_paf(
                    index.seq_index,
                    results,
                    out,
                    name,
                    merge_distance,
                    args.original_sequence_coordinates,
                    original_length_lookup=_original_length_lookup(args),
                )
            elif fmt == "gbwt":
                gbwt_sequences.extend(outputs.collect_region_sequences(
                    index.seq_index, results, seq_idx, merge_distance))
            else:
                if not args.sequence_files:
                    print(
                        f"error: -o {fmt} requires --sequence-files",
                        file=sys.stderr,
                    )
                    return 2
                if seq_idx is None:
                    seq_idx = _sequence_index(args)
                if fmt == "fasta+paf":
                    # FASTA part (self row included, strands separate), then
                    # PAF over the SAME (fasta-merged) results without the
                    # self row (main.rs:7601-7623).
                    outputs.write_fasta(
                        index.seq_index, results, out, seq_idx,
                        merge_distance, False, args.reverse_complement,
                    )
                    results.pop(0)
                    outputs.write_paf(
                        index.seq_index, results, out, name, merge_distance,
                        args.original_sequence_coordinates,
                        original_length_lookup=_original_length_lookup(args),
                    )
                else:
                    _emit_region_format(
                        index, results, out, fmt, args, seq_idx, gfa_stages,
                        target_id, merge_distance,
                    )
        if gbwt_sequences is not None:
            _write_region_gbwt(gbwt_sequences, args.output)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _write_region_gbwt(sequences, prefix: str, **params) -> None:
    """Save the regional syng index of `-o gbwt` and report it."""
    from impg_tpu_torch.query import outputs

    path = outputs.write_region_gbwt(sequences, prefix, **params)
    print(
        f"Wrote region syng index over {len(sequences)} "
        f"interval sequence(s): {path}",
        file=sys.stderr,
    )


def _stats_region_depth(args, index, device: torch.device) -> int:
    """`stats -r/-b`: per-region overlapping directed-record counts.

    Reference role: per-tree interval accounting (main.rs:13194
    print_stats), extended to arbitrary regions.  The device path is K-A
    (the engine's stab_counts); the host path is the index's own stab —
    both count the same closed-interval overlaps.
    """
    import numpy as np

    if args.target_bed:
        targets = bed_mod.parse_bed_file(args.target_bed)
    else:
        targets = [bed_mod.parse_target_range(args.target_range)]
    tids, spans = [], []
    for name, (s, e), _label in targets:
        sid = index.seq_index.get_id(name)
        if sid is None:
            print(f"error: sequence '{name}' not found in index",
                  file=sys.stderr)
            return 2
        tids.append(sid)
        spans.append((s, e))
    engine = resolve_compute_engine(args, index, n_targets=len(targets),
                                    device=device)
    if engine is not None and hasattr(engine, "stab_counts"):
        counts = engine.stab_counts(
            np.asarray(tids, np.int32),
            np.asarray([s for s, _ in spans], np.int32),
            np.asarray([e for _, e in spans], np.int32),
        )
    else:
        counts = [index.stab(t, s, e).size
                  for t, (s, e) in zip(tids, spans)]
    print("Region\tOverlapping_records")
    for (name, (s, e), _label), c in zip(targets, counts):
        print(f"{name}:{s}-{e}\t{int(c)}")
    return 0


def cmd_stats(args, device: torch.device) -> int:
    index = _load_index(args)
    if getattr(args, "target_range", None) or getattr(args, "target_bed", None):
        return _stats_region_depth(args, index, device)
    if args.list_sequences:
        print("Sequence\tLength")
        for i in range(len(index.seq_index)):
            print(
                f"{index.seq_index.get_name(i)}\t{index.seq_index.get_len_from_id(i)}"
            )
        return 0
    counts = []
    for sid in range(len(index.seq_index)):
        n = index.tree_size(sid)
        if n:
            counts.append((index.seq_index.get_name(sid), n))
    total = sum(c for _, c in counts)
    print(f"Sequences: {len(index.seq_index)}")
    print(f"Sequences with alignments: {len(counts)}")
    print(f"Directed intervals: {total}")
    if counts:
        import statistics

        vals = [c for _, c in counts]
        print(f"Mean intervals per sequence: {total / len(counts):.2f}")
        print(f"Median intervals per sequence: {statistics.median(vals)}")
    return 0


def cmd_partition(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import partition as partition_mod

    if args.merge_distance is None and not args.no_merge:
        print(
            "error: -d/--merge-distance is required. Use --no-merge to disable.",
            file=sys.stderr,
        )
        return 2
    merge_distance = -1 if args.no_merge else bed_mod.parse_size(args.merge_distance)
    # All formats support single-file collected output (the reference only
    # allows BED there, main.rs:6368; paf/fasta/maf/gfa/vcf are extensions).
    sequence_index = None
    if args.output_format in ("fasta", "gfa", "maf", "vcf"):
        if not args.sequence_files:
            print(
                f"error: -o {args.output_format} requires --sequence-files",
                file=sys.stderr,
            )
            return 2
        sequence_index = _sequence_index(args)
    index = _load_index(args)

    device_engine = resolve_compute_engine(
        args, index,
        n_targets=1 + len(index.seq_index) // 4,  # windows per round
        # Partition's per-window walks carry masked regions (supported
        # natively) but no CIGARs/identity/subset unless asked.
        native_ok=not args.transitive_dfs,
        device=device,
    )

    partition_mod.partition_alignments(
        index,
        bed_mod.parse_size(args.window_size),
        starting_sequences_file=args.starting_sequences_file,
        selection_mode=args.selection_mode,
        merge_distance=merge_distance,
        min_identity=args.min_result_identity,
        min_missing_size=args.min_missing_size,
        min_boundary_distance=args.min_boundary_distance,
        transitive_dfs=args.transitive_dfs,
        max_depth=args.max_depth,
        min_transitive_len=args.min_transitive_len,
        min_distance_between_ranges=args.min_distance_between_ranges,
        output_format=args.output_format,
        output_folder=args.output_folder,
        separate_files=args.separate_files,
        rehome_singletons=not args.no_rehome_singletons,
        device_engine=device_engine,
        sequence_index=sequence_index,
    )
    return 0


def cmd_refine(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import refine as refine_mod
    from impg_tpu_torch.query.subset import SubsetFilter

    if args.target_range is None and args.target_bed is None:
        print(
            "error: either --target-range or --target-bed must be provided",
            file=sys.stderr,
        )
        return 2
    if args.merge_distance is None and not args.no_merge:
        print(
            "error: -d/--merge-distance is required. Use --no-merge to disable.",
            file=sys.stderr,
        )
        return 2
    merge_distance = -1 if args.no_merge else bed_mod.parse_size(args.merge_distance)
    index = _load_index(args)
    if args.target_bed:
        targets = bed_mod.parse_bed_file(args.target_bed)
    else:
        targets = [bed_mod.parse_target_range(args.target_range)]

    subset = (
        SubsetFilter.load(args.subset_sequence_list)
        if args.subset_sequence_list
        else None
    )
    blacklist = None
    if args.blacklist_bed:
        blacklist = {}
        for name, (s, e), _ in bed_mod.parse_bed_file(args.blacklist_bed):
            blacklist.setdefault(name, []).append((s, e))

    config = refine_mod.RefineConfig(
        span_bp=args.span_bp,
        max_extension=args.max_extension,
        support_level=args.pansn_mode,
        extension_step=args.extension_step,
        merge_distance=merge_distance,
        min_identity=args.min_result_identity,
        use_transitive_bfs=args.transitive and not args.transitive_dfs,
        use_transitive_dfs=args.transitive and args.transitive_dfs,
        max_transitive_depth=args.max_depth,
        min_transitive_len=args.min_transitive_len,
        min_distance_between_ranges=args.min_distance_between_ranges,
        subset_match=subset.matches if subset else None,
        blacklist=blacklist,
    )
    device_engine = resolve_compute_engine(
        args, index, n_targets=len(targets) * 8,  # flank-grid candidates
        native_ok=(args.transitive and not args.transitive_dfs),
        device=device,
    )
    records = refine_mod.run_refine(
        index, targets, config, device_engine=device_engine
    )
    support_out = open(args.support_output, "w") if args.support_output else None
    try:
        refine_mod.write_refine_output(records, sys.stdout, support_out)
    finally:
        if support_out:
            support_out.close()
    return 0


def cmd_similarity(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import similarity as sim_mod
    from impg_tpu_torch.query import engine, merge as merge_mod
    from impg_tpu_torch.query.subset import SubsetFilter

    if args.target_range is None and args.target_bed is None:
        print(
            "error: either --target-range or --target-bed must be provided",
            file=sys.stderr,
        )
        return 2
    if args.merge_distance is None and not args.no_merge:
        print(
            "error: -d/--merge-distance is required. Use --no-merge to disable.",
            file=sys.stderr,
        )
        return 2
    merge_distance = -1 if args.no_merge else bed_mod.parse_size(args.merge_distance)
    scoring = _poa_scoring(args.poa_scoring)
    if len(scoring) != 6:
        print("error: --poa-scoring needs 6 comma-separated values", file=sys.stderr)
        return 2

    index = _load_index(args)
    seq_idx = _sequence_index(args)

    if args.target_bed:
        targets = bed_mod.parse_bed_file(args.target_bed)
    else:
        if ":" in args.target_range:
            targets = [bed_mod.parse_target_range(args.target_range)]
        else:
            sid = index.seq_index.get_id(args.target_range)
            if sid is None:
                print(
                    f"error: sequence '{args.target_range}' not found in index",
                    file=sys.stderr,
                )
                return 1
            L = index.seq_index.get_len_from_id(sid)
            targets = [
                (args.target_range, (0, L), f"{args.target_range}:0-{L}")
            ]

    subset = (
        SubsetFilter.load(args.subset_sequence_list)
        if args.subset_sequence_list
        else None
    )
    subset_match = subset.matches if subset else None

    # The engine runs the region-gathering transitive BFS, one walk a
    # target as in impg_tpu.cli (the row order is its order); the POA MSA
    # and the metric stages follow on the host.
    device_engine = (
        resolve_compute_engine(
            args, index, n_targets=len(targets), native_ok=True,
            device=device,
        )
        if args.transitive and not args.transitive_dfs
        else None
    )

    print(sim_mod.similarity_header(args.distances))
    pca_results: list = []
    for target_name, (start, end), name in targets:
        tid = index.seq_index.get_id(target_name)
        if tid is None:
            print(
                f"error: target sequence '{target_name}' not found in index",
                file=sys.stderr,
            )
            return 1
        if args.transitive:
            walker = (
                engine.query_transitive_dfs
                if args.transitive_dfs
                else engine.query_transitive_bfs
            )
            kwargs = dict(
                max_depth=args.max_depth,
                min_transitive_len=args.min_transitive_len,
                min_distance_between_ranges=args.min_distance_between_ranges,
                min_output_length=args.min_output_length,
                min_identity=args.min_result_identity,
                subset_match=subset_match,
            )
            if device_engine is not None:
                kwargs["device_engine"] = device_engine
            results = walker(index, tid, start, end, **kwargs)
        else:
            results = engine.query(
                index, tid, start, end, min_identity=args.min_result_identity
            )
            if args.min_output_length is not None:
                results = [
                    r for r in results
                    if abs(r.q_last - r.q_first) >= args.min_output_length
                ]
        merge_mod.merge_query_adjusted_intervals(results, merge_distance, True)
        region = f"{target_name}:{start}-{end}"
        text, sims = sim_mod.compute_similarities_for_region(
            index, results, seq_idx, scoring, args.distances,
            args.emit_all_pairs, args.delim, args.delim_pos, region,
        )
        sys.stdout.write(text)
        if args.pca and sims:
            dm, labels = sim_mod.build_distance_matrix(sims, args.pca_similarity)
            try:
                coords, _ = sim_mod.mds_fit_transform(dm, args.pca_components)
            except ValueError as e:
                print(f"warning: PCA skipped for {region}: {e}", file=sys.stderr)
                continue
            pca_results.append(
                sim_mod.PcaResult(region=region, labels=labels, coords=coords)
            )
    if pca_results:
        # Sign polarization across region windows (reference:
        # similarity.rs:210-220): guide samples win over adaptive mode.
        if args.polarize_guide_samples:
            guides = [
                g for g in args.polarize_guide_samples.split(",") if g
            ]
            try:
                sim_mod.polarize_with_guides(pca_results, guides)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
        elif args.polarize_n_prev > 0:
            sim_mod.polarize_adaptive(pca_results, args.polarize_n_prev)
        for res in pca_results:
            for li, label in enumerate(res.labels):
                comps = "\t".join(f"{c:.6f}" for c in res.coords[li])
                print(f"#PCA\t{res.region}\t{label}\t{comps}")
    return 0


def _comma_list(entries) -> list[str]:
    return [x for e in (entries or []) for x in e.split(",") if x]


def _cuda_checked(args, device: torch.device) -> None:
    """Exit 2 for `device` or `mesh` on a CUDA device when CUDA is absent
    (as `query` does)."""
    spec = getattr(args, "compute_engine", "auto")
    if spec in ("device", "mesh") and device.type == "cuda" \
            and not torch.cuda.is_available():
        _fail(f"--compute-engine {spec} needs a CUDA device")


def cmd_syng(args, device: torch.device) -> int:
    from impg_tpu_torch.syng.index import SyngIndex

    _cuda_checked(args, device)
    files = _comma_list(args.fasta_files)
    # Build extraction: the threaded native kernel wins on one-shot builds,
    # so `auto` stays native; K-F runs on an explicit `device` or `mesh`
    # (bit-exact either way).
    on_device = args.compute_engine in ("device", "mesh")
    idx = SyngIndex.build_from_fasta(
        files, k=args.syncmer_k, w=args.syncmer_w, seed=args.syncmer_seed,
        threads=getattr(args, "threads", 1) or 1,
        extractor="device" if on_device else "native", device=device,
    )
    path = idx.save(args.output)
    print(
        f"Indexed {idx.occ_ids.size} syncmer occurrences over "
        f"{len(idx.seq_index)} sequences -> {path}",
        file=sys.stderr,
    )
    return 0


def cmd_map(args, device: torch.device) -> int:
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.syng.pack import map_reads

    _cuda_checked(args, device)
    reads = _comma_list(args.reads)
    if args.output_format in ("gaf", "paf") and args.alignment and not args.graph:
        # Syng-index read mapping (reference main.rs:719 map -o gaf|paf):
        # GAF rows carry the signed syncmer-node walk (syng-gaf-walk read
        # space); PAF rows are anchor-chained projections onto indexed paths.
        from impg_tpu_torch.syng import map as syng_map

        index = SyngIndex.load(args.alignment)
        out = open(args.output, "w") if args.output else sys.stdout
        try:
            n = 0
            if args.output_format == "gaf":
                rows = syng_map.map_reads_gaf(
                    index, reads, min_anchors=args.min_anchors
                )
            else:
                rows = syng_map.map_reads_paf(
                    index, reads,
                    min_anchors=args.min_anchors,
                    chain_budget=args.chain_budget,
                    max_hits=args.max_hits,
                )
            for line in rows:
                out.write(line + "\n")
                n += 1
            print(
                f"Mapped reads -> {n} {args.output_format.upper()} row(s)",
                file=sys.stderr,
            )
        finally:
            if out is not sys.stdout:
                out.close()
        return 0
    if (args.output_format in ("gaf", "graph-pack-tsv", "graph-pack")
            or args.graph):
        if not args.graph:
            print(
                "error: -o gaf/graph-pack[-tsv] needs --graph or -a",
                file=sys.stderr,
            )
            return 2
        return _map_graph(args, reads)
    if not (args.alignment and args.output):
        print("error: map needs -a and -O (or --graph)", file=sys.stderr)
        return 2
    index = SyngIndex.load(args.alignment)
    if args.compute_engine in ("device", "mesh"):
        # K-G read->pack batches, counts resident on the device; equal to
        # map_reads.  `auto` stays host (a one-shot command).
        from impg_tpu_torch.ops.syncmer_device import map_reads_batched

        pack, n_reads, n_matched = map_reads_batched(index, reads,
                                                     device=device)
    else:
        pack, n_reads, n_matched = map_reads(index, reads)
    if args.output_format == "pack-tsv":
        with open(args.output, "w") as fh:
            pack.write_tsv(fh)
    elif args.output_format == "proj":
        _write_proj_bundle(args, index, reads, pack, n_reads, n_matched)
    else:
        pack.save(args.output)
    print(
        f"Mapped {n_reads} reads: {n_matched} syncmer matches over "
        f"{pack.feature_ids.size} features -> {args.output}",
        file=sys.stderr,
    )
    return 0


def _map_graph(args, reads: list[str]) -> int:
    """`map --graph`: reads against the GFA's path walks, on the host (as
    impg_tpu.cli): graph-pack (IMPGPKB1, -O needed), gaf, paf (the GAF
    surjected onto the paths' source frames), else graph-pack-tsv."""
    from impg_tpu_torch.genotype import graph as graph_mod
    from impg_tpu_torch.graph.gfa import Gfa

    with open(args.graph) as fh:
        gfa = Gfa.parse(fh.read())
    if args.output_format == "graph-pack":
        # Reference-compatible binary pack (pack.rs IMPGPKB1): node
        # i = the graph's i-th S line (1-based), counts = rounded
        # covered bp.  Readable by the reference CLI and by
        # `genotype cos --graph --pack`.
        import numpy as np

        from impg_tpu_torch.io import packbin

        if not args.output:
            print(
                "error: -o graph-pack needs -O FILE (binary)",
                file=sys.stderr,
            )
            return 2
        counts, n_reads, n_matched = graph_mod.map_reads_to_graph(gfa, reads)
        n_segs = len(gfa.segments)
        ids = np.array(sorted(counts), np.int64) + 1
        vals = np.array(
            [round(counts[i - 1]) for i in ids.tolist()], np.int64
        )
        nz = packbin.write_packbin(
            args.output, ids, vals, n_segs, retained_records=n_matched
        )
        print(
            f"Mapped {n_matched}/{n_reads} reads -> IMPGPKB1 pack "
            f"({nz} nonzero of {n_segs} segments)",
            file=sys.stderr,
        )
        return 0
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        if args.output_format == "gaf":
            n = 0
            for line in graph_mod.map_reads_gaf(gfa, reads):
                out.write(line + "\n")
                n += 1
            print(f"Mapped {n} reads -> GAF", file=sys.stderr)
        elif args.output_format == "paf":
            n = 0
            for line in graph_mod.surject_gaf_to_paf(
                gfa, graph_mod.map_reads_gaf(gfa, reads)
            ):
                out.write(line + "\n")
                n += 1
            print(
                f"Mapped {n} reads -> PAF (surjected onto source "
                "coordinates)",
                file=sys.stderr,
            )
        else:
            counts, n_reads, n_matched = graph_mod.map_reads_to_graph(
                gfa, reads
            )
            ords = graph_mod.segment_ordinals(gfa)
            names = {v: k for k, v in ords.items()}
            out.write("#feature_space\tgfa-segment\n")
            out.write("segment\tcovered_bp\n")
            for fid in sorted(counts):
                out.write(f"{names[fid]}\t{counts[fid]:.0f}\n")
            print(
                f"Mapped {n_matched}/{n_reads} reads over "
                f"{len(counts)} segments",
                file=sys.stderr,
            )
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _write_proj_bundle(args, index, reads, pack, n_reads, n_matched) -> None:
    """`map -o proj`: a projection bundle (reference: projection.rs:12
    ProjectionManifest — sample.proj/ = manifest.json + pack artifact) that
    also carries each read's signed syncmer-node walk as GAF
    (projection.rs:53 read_space "syng-gaf-walk")."""
    import json

    from impg_tpu_torch.syng import map as syng_map

    os.makedirs(args.output, exist_ok=True)
    pack.save(os.path.join(args.output, "sample.packt"))
    n_gaf = 0
    with open(os.path.join(args.output, "sample.gaf"), "w") as fh:
        for row in syng_map.map_reads_gaf(index, reads):
            fh.write(row + "\n")
            n_gaf += 1
    with open(os.path.join(args.output, "manifest.json"), "w") as fh:
        json.dump(
            dict(
                format="impg-tpu-projection-bundle",
                version=1,
                feature_space=pack.feature_space,
                evidence_backend=pack.backend,
                index=args.alignment,
                reads=reads,
                n_reads=n_reads,
                n_matched_syncmers=n_matched,
                n_features=int(pack.feature_ids.size),
                read_space="syng-gaf-walk",
                n_gaf_records=n_gaf,
                files=dict(pack="sample.packt", gaf="sample.gaf"),
            ),
            fh,
            indent=2,
        )


def _pack_stem(path: str) -> str:
    base = os.path.basename(path)
    return base.split(".")[0] or base


def _device_tristate(args) -> bool | None:
    """impg_tpu.cli's tristate for the dense diploid search: device and
    mesh -> True, auto -> None (the FLOP crossover decides), host/native ->
    False."""
    return {"device": True, "mesh": True, "auto": None}.get(
        args.compute_engine, False)


def _graph_pack_counts(pack_path: str) -> dict[int, float]:
    """Per-segment evidence of one pack: the reference's binary pack
    (pack.rs IMPGPKB1, node i = i-th S line 1-based) or its
    '#node_id\tcount' TSV (pack.rs write_tsv/read_tsv), as {ordinal: count}."""
    from impg_tpu_torch.io import packbin

    if packbin.is_packbin(pack_path):
        node_ids, cvals, _meta = packbin.read_packbin(pack_path)
        return {
            int(n) - 1: float(c)
            for n, c in zip(node_ids.tolist(), cvals.tolist())
        }
    counts = {}
    with open(pack_path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            nid, cnt = line.split("\t")[:2]
            if int(cnt) > 0:
                counts[int(nid) - 1] = float(cnt)
    return counts


def _genotype_graph(args, device: torch.device) -> int:
    """`genotype --graph` (gfa-segment feature space, genotype.rs:1563): the
    reads mapped to the graph's path walks, or one pack; a render bundle's
    regional graph through its manifest.json.  The dense ploidy-2 search
    runs on `device` (the cuBLAS products and K-H) under the tristate."""
    from impg_tpu_torch.genotype import graph as gt_graph
    from impg_tpu_torch.genotype.core import qv_from_similarity

    if not args.reads and not args.pack:
        print(
            "error: --graph genotyping needs -q/--reads or -p/--pack",
            file=sys.stderr,
        )
        return 2
    reads = _comma_list(args.reads)
    gpacks = _comma_list(args.pack)
    if len(gpacks) > 1:
        print(
            "error: --graph genotyping takes one pack; cohort "
            "packs are supported on the syng backend",
            file=sys.stderr,
        )
        return 2
    sample_counts = _graph_pack_counts(gpacks[0]) if gpacks else None
    graph_path = args.graph
    if os.path.isdir(graph_path):
        # Render bundle: use its regional graph (genotype.rs:1016
        # GraphSource::RenderBundle).
        import json

        with open(os.path.join(graph_path, "manifest.json")) as fh:
            man = json.load(fh)
        graph_path = os.path.join(
            graph_path, man.get("files", {}).get("gfa", "render.gfa")
        )
    with open(graph_path) as fh:
        gfa_text = fh.read()
    candidates, results, region = gt_graph.genotype_graph(
        gfa_text,
        reads,
        target_path=args.target_path,
        ploidy=args.ploidy,
        contribution_model=args.contribution_model,
        sample_counts=sample_counts,
        device=_device_tristate(args),
        top_n=args.top_n,
        torch_device=device,
    )
    if not results:
        print("error: no graph candidates found", file=sys.stderr)
        return 1
    sample = "sample" if args.sample_name is None else args.sample_name
    print("#sample\tregion\trank\tcombination\tsimilarity\tqv")
    for rank, r in enumerate(results[: args.top_n], 1):
        combo = ";".join(
            f"{candidates[i].path_name}:{candidates[i].start}-"
            f"{candidates[i].end}"
            for i in r.combination
        )
        print(
            f"{sample}\t{region}\t{rank}\t{combo}\t"
            f"{r.similarity:.6f}\t{qv_from_similarity(r.similarity):.1f}"
        )
    return 0


def cmd_genotype(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import genotype as gt_mod
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.syng.pack import Pack

    _cuda_checked(args, device)
    if args.graph:
        return _genotype_graph(args, device)
    pack_paths = _comma_list(args.pack)
    if not (args.alignment and pack_paths and args.target_range):
        print(
            "error: genotype needs -a, -p and -r (or --graph with -q)",
            file=sys.stderr,
        )
        return 2
    if len(pack_paths) > 1 and args.sample_name is not None:
        # impg_tpu.cli names cohort rows by their packs' file stems and
        # drops --sample-name without a word.
        print("error: --sample-name names a single pack's rows; a cohort's "
              "rows are named by their packs' file stems", file=sys.stderr)
        return 2
    single = "sample" if args.sample_name is None else args.sample_name
    names = ([single] if len(pack_paths) == 1
             else [_pack_stem(p) for p in pack_paths])
    if len(set(names)) != len(names):
        # impg_tpu.cli names cohort rows by the pack's file stem and would
        # print rows that cannot be told apart.
        dup = sorted({n for n in names if names.count(n) > 1})
        print(f"error: cohort packs share the file stem(s) {', '.join(dup)}; "
              "their rows could not be told apart (rename the packs)",
              file=sys.stderr)
        return 2
    index = SyngIndex.load(args.alignment)
    target_name, (start, end), region = bed_mod.parse_target_range(
        args.target_range
    )
    packs = [(nm, Pack.load(p)) for nm, p in zip(names, pack_paths)]
    candidates, multi = gt_mod.genotype_cos_multi(
        index,
        packs,
        target_name,
        start,
        end,
        ploidy=args.ploidy,
        top_n=args.top_n,
        max_combinations=args.max_combinations,
        mode=args.candidate_mode,
        device=_device_tristate(args),
        torch_device=device,
    )
    if not multi or not any(r for _, r in multi):
        print("error: no candidates found for region", file=sys.stderr)
        return 1
    for i, (nm, results) in enumerate(multi):
        gt_mod.write_genotype_report(
            sys.stdout, region, candidates, results, nm,
            header=(i == 0),
        )
    return 0


def cmd_sort(args, device: torch.device) -> int:
    from impg_tpu_torch.graph import sortgfa as sortgfa_mod

    try:
        out_text = sortgfa_mod.sort_pipeline(
            _read_gfa(args.gfa), args.pipeline, sgd_backend=args.sgd_backend,
            device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _write_out(args.output, out_text)
    return 0


def cmd_export_1aln(args) -> int:
    from impg_tpu_torch.io import onealn as onealn_mod

    index = _load_index(args)
    tp = index.ensure_tracepoints(args.spacing)
    n = onealn_mod.write_1aln(
        args.output, index.seq_index, index.records, index.arena, tp,
        binary=args.binary,
    )
    form = "binary" if args.binary else "ASCII"
    print(f"Wrote {n} alignments ({form}) -> {args.output}", file=sys.stderr)
    return 0


def cmd_export_tpa(args) -> int:
    from impg_tpu_torch.io import tpa as tpa_mod

    index = _load_index(args)
    tp = index.ensure_tracepoints(args.spacing)
    n = tpa_mod.write_tpa(
        args.output, index.seq_index, index.records, index.arena, tp,
        tp_type=args.tp_mode,
    )
    print(f"Wrote {n} alignments -> {args.output}", file=sys.stderr)
    return 0


def cmd_read_index(args) -> int:
    from impg_tpu_torch.syng.read_index import ReadSyncmerIndex

    idx = ReadSyncmerIndex.build(
        _comma_list(args.reads), k=args.syncmer_k, w=args.syncmer_w,
        seed=args.syncmer_seed,
    )
    path = idx.save(args.output)
    print(
        f"Indexed {len(idx.read_names)} reads, {idx.ids.size} distinct "
        f"syncmers -> {path}",
        file=sys.stderr,
    )
    return 0


def cmd_syng2gfa(args) -> int:
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.syng.syng2gfa import paths_to_walks, syng_to_gfa

    syng = SyngIndex.load(args.alignment)
    text = syng_to_gfa(
        syng, _sequence_index(args),
        drop_top_fraction=args.drop_top_fraction,
        max_occurrences=args.max_occurrences,
        mode=args.mode,
        cut_n_gaps=args.cut_ns,
        cut_n_min_run=args.cut_n_min_run,
    )
    if args.gfa_version == "1.1":
        lengths = {
            syng.seq_index.get_name(i): syng.seq_index.get_len_from_id(i)
            for i in range(len(syng.seq_index))
        }
        text = paths_to_walks(text, lengths)
    _write_out(args.output, text)
    return 0


def cmd_syng_repair(args) -> int:
    """Validate + rebuild a .syngt artifact's derived state without
    re-reading source sequences (reference: Args::SyngRepair
    main.rs:10140 rebuilds the positional sidecars from the GBWT alone;
    the artifact stores direct positions, so repair = invariant check +
    re-canonicalization of the occurrence-table sort order)."""
    import numpy as np

    from impg_tpu_torch.core.seqidx import SequenceIndex
    from impg_tpu_torch.syng import index as syng_index_mod

    path = args.index
    if not path.endswith(syng_index_mod.SYNG_SUFFIX):
        path = path + syng_index_mod.SYNG_SUFFIX
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        return 1
    required = {
        "version", "names", "lengths", "occ_ids", "occ_seq", "occ_pos",
        "occ_fwd", "params",
    }
    missing = required - set(arrays)
    if missing:
        print(
            f"error: {path} is missing arrays: {sorted(missing)} "
            "(not repairable without source sequences; rebuild with "
            "`syng`)",
            file=sys.stderr,
        )
        return 1
    n = arrays["occ_ids"].size
    if not all(
        arrays[k].size == n for k in ("occ_seq", "occ_pos", "occ_fwd")
    ):
        print(
            f"error: {path} occurrence columns disagree in length "
            "(truncated write; rebuild with `syng`)",
            file=sys.stderr,
        )
        return 1
    n_seqs = arrays["names"].size
    problems = []
    if n and (
        int(arrays["occ_seq"].min()) < 0
        or int(arrays["occ_seq"].max()) >= n_seqs
    ):
        problems.append("occ_seq ids out of range")
    if n:
        lens = arrays["lengths"][arrays["occ_seq"]]
        if int((arrays["occ_pos"] < 0).sum()) or int(
            (arrays["occ_pos"] >= lens).sum()
        ):
            problems.append("occ_pos outside sequence bounds")
    order = np.lexsort(
        (arrays["occ_pos"], arrays["occ_seq"], arrays["occ_ids"])
    )
    sorted_ok = bool((order == np.arange(n)).all())
    if problems:
        print(
            f"error: {path}: " + "; ".join(problems) + " — data is "
            "inconsistent with its name table; rebuild with `syng`",
            file=sys.stderr,
        )
        return 1
    if sorted_ok and not args.force:
        print(
            f"{path}: OK ({n} occurrences over {n_seqs} sequence(s), "
            "canonical order). Use --force to rewrite anyway.",
            file=sys.stderr,
        )
        return 0
    for k in ("occ_ids", "occ_seq", "occ_pos", "occ_fwd"):
        arrays[k] = arrays[k][order]
    idx = syng_index_mod.SyngIndex(
        seq_index=SequenceIndex.from_lists(
            arrays["names"], arrays["lengths"]
        ),
        occ_ids=arrays["occ_ids"],
        occ_seq=arrays["occ_seq"],
        occ_pos=arrays["occ_pos"],
        occ_fwd=arrays["occ_fwd"],
        k=int(arrays["params"][0]),
        w=int(arrays["params"][1]),
        seed=int(arrays["params"][2]),
    )
    idx.save(path)
    what = "rewritten" if sorted_ok else "re-canonicalized and rewritten"
    print(f"{path}: {what} ({n} occurrences).", file=sys.stderr)
    return 0


def cmd_infer(args) -> int:
    """Windowed allele inference with mosaic stitching, on the host as in
    impg_tpu.cli (candidates scored by genotype_cos on the host, whatever
    `--compute-engine` says)."""
    from impg_tpu_torch.commands import infer as infer_mod
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.syng.pack import Pack

    if not args.target_range and not args.target_bed:
        print(
            "error: infer needs -r/--target-range or -b/--target-bed",
            file=sys.stderr,
        )
        return 2
    index = SyngIndex.load(args.alignment)
    pack = Pack.load(args.pack)
    if args.target_bed:
        # Partition mode (infer.rs modes-from-inputs role): one windowed
        # inference per BED row, all streamed into one report.
        regions = [
            (chrom, rng[0], rng[1])
            for chrom, rng, _name in bed_mod.parse_bed_file(args.target_bed)
        ]
    else:
        chrom, (start, end), _ = bed_mod.parse_target_range(
            args.target_range
        )
        regions = [(chrom, start, end)]
    read_index = None
    if args.read_index:
        from impg_tpu_torch.syng.read_index import ReadSyncmerIndex

        read_index = ReadSyncmerIndex.load(args.read_index)
    # Per-read GAF MEMs are region-independent: parse + GBWT-match ONCE
    # and reuse the evidence across every BED row.
    gaf_evidence = args.gaf
    if args.gaf and args.read_link_weight > 0.0 and len(regions) > 1:
        gaf_evidence = infer_mod.GafEvidence(index, args.gaf)
    any_calls = False
    windows = path = segments = None
    for ri, (chrom, start, end) in enumerate(regions):
        windows, path, segments = infer_mod.run_infer(
            index, pack, chrom, start, end,
            window=args.window,
            ploidy=args.ploidy,
            top_n=args.top_n,
            switch_penalty=args.switch_penalty,
            candidate_mode=args.candidate_mode,
            read_index=read_index,
            read_link_weight=args.read_link_weight,
            min_read_link_anchors=args.min_read_link_anchors,
            gaf_path=gaf_evidence,
        )
        if not windows:
            print(
                f"warning: no calls for {chrom}:{start}-{end}",
                file=sys.stderr,
            )
            continue
        any_calls = True
        if ri == 0 or len(regions) == 1:
            infer_mod.write_infer_report(
                sys.stdout, windows, path, segments, args.sample_name
            )
        else:
            import io as io_mod

            buf = io_mod.StringIO()
            infer_mod.write_infer_report(
                buf, windows, path, segments, args.sample_name
            )
            sys.stdout.write(
                "".join(
                    l
                    for l in buf.getvalue().splitlines(keepends=True)
                    if not l.startswith("#")
                )
            )
    if not any_calls:
        print("error: no calls produced for any region", file=sys.stderr)
        return 1
    if args.write_haplotypes:
        if len(regions) > 1:
            print(
                "error: --write-haplotypes supports a single -r region",
                file=sys.stderr,
            )
            return 2
        if not args.sequence_files:
            print(
                "error: --write-haplotypes needs --sequence-files",
                file=sys.stderr,
            )
            return 2
        paths = infer_mod.write_haplotype_fastas(
            windows, path, _sequence_index(args), args.write_haplotypes,
            args.sample_name,
        )
        print(
            "Wrote haplotype FASTAs: " + ", ".join(paths), file=sys.stderr
        )
    return 0


# ---- The GFA toolbox: host commands, as in impg_tpu.cli ----


def cmd_lace(args) -> int:
    files: list[str] = []
    for entry in (args.gfa_files or []) + (args.files or []):
        files.extend(x for x in entry.split(",") if x)
    for list_path in (args.gfa_list, args.file_list):
        if list_path:
            with open(list_path) as fh:
                files.extend(
                    l.strip() for l in fh
                    if l.strip() and not l.strip().startswith("#")
                )
    if not files:
        print("error: no input files specified", file=sys.stderr)
        return 2
    fmt = args.format
    if fmt == "auto":
        # Extension of the first file decides (main.rs determine_file_format)
        fmt = (
            "vcf"
            if files[0].endswith((".vcf", ".vcf.gz", ".vcf.zst", ".vcf.bgz"))
            else "gfa"
        )
    seq_idx = _sequence_index(args) if args.sequence_files else None
    if fmt == "vcf":
        from impg_tpu_torch.graph import vcf_lace

        text = vcf_lace.lace_vcfs(files, seq_idx)
    else:
        from impg_tpu_torch.graph import lace as lace_mod

        text = lace_mod.lace_files(files, args.fill_gaps, seq_idx)
    if args.output.endswith(".gz"):
        import gzip as gzip_mod

        with gzip_mod.open(args.output, "wt") as fh:
            fh.write(text)
    elif args.output.endswith(".zst"):
        try:  # not installed on every machine: a precise error, not a trace
            import zstandard
        except ImportError:
            print(f"error: writing '{args.output}' needs the zstandard "
                  "package, which is not installed; write a .gz or plain "
                  "output instead", file=sys.stderr)
            return 1
        with open(args.output, "wb") as raw:
            raw.write(zstandard.ZstdCompressor().compress(text.encode()))
    else:
        with open(args.output, "w") as fh:
            fh.write(text)
    print(
        f"Laced {len(files)} {fmt.upper()}s -> {args.output}",
        file=sys.stderr,
    )
    return 0


# The module a job list's commands run (impg_tpu.cli writes its own name).
JOB_LIST_MODULE = "impg_tpu_torch.cli"


def _run_joblist(args) -> int:
    """Execute an existing joblist (one shell command per line) with
    parallel slots + progress (align.rs --run-joblist role)."""
    import concurrent.futures
    import subprocess
    import time as time_mod

    with open(args.run_joblist) as fh:
        cmds = [l.strip() for l in fh if l.strip() and not l.startswith("#")]
    jobs = args.jobs or getattr(args, "threads", None) or os.cpu_count() or 4
    t0 = time_mod.perf_counter()
    failed = 0
    done = 0

    def run_one(cmd: str) -> int:
        return subprocess.run(cmd, shell=True).returncode

    with concurrent.futures.ThreadPoolExecutor(max_workers=jobs) as ex:
        for rc in ex.map(run_one, cmds):
            done += 1
            if rc != 0:
                failed += 1
            if done % max(len(cmds) // 20, 1) == 0 or done == len(cmds):
                dt = time_mod.perf_counter() - t0
                eta = dt / done * (len(cmds) - done)
                print(
                    f"[joblist] {done}/{len(cmds)} "
                    f"({failed} failed) elapsed {dt:.0f}s eta {eta:.0f}s",
                    file=sys.stderr,
                )
    return 1 if failed else 0


def cmd_align(args) -> int:
    from impg_tpu_torch.commands import align as align_mod

    if args.run_joblist:
        return _run_joblist(args)
    files = _comma_list(args.fasta_files)
    scoring = tuple(int(x) for x in args.scoring.split(","))
    if len(scoring) != 4:
        print("error: --scoring needs 4 comma-separated values", file=sys.stderr)
        return 2
    config = align_mod.AlignConfig(
        min_anchors=args.min_anchors,
        max_gap=args.max_gap,
        min_chain_span=args.min_chain_span,
        scoring=scoring,
        sparsify=args.sparsify,
        mash_k=args.mash_k,
        sketch_size=args.sketch_size,
    )
    pairs = None
    if args.pair:
        pairs = []
        for spec in args.pair:
            q, _, t = spec.partition(":")
            if not q or not t:
                print(
                    f"error: --pair needs QUERY:TARGET, got '{spec}'",
                    file=sys.stderr,
                )
                return 2
            pairs.append((q, t))
    if args.job_list:
        # Job-list output (align.rs AlignOutputFormat::JobList): one
        # self-contained command per selected pair for cluster execution,
        # each running this package's CLI.
        from impg_tpu_torch.commands.graph import load_sequences

        seqs = load_sequences(files)
        if pairs is None:
            pairs = align_mod.select_pairs(
                list(seqs), seqs, config.sparsify,
                mash_k=config.mash_k, sketch_size=config.sketch_size,
            )
        file_args = ",".join(files)
        _write_out(args.output, "".join(
            f"python -m {JOB_LIST_MODULE} align -f {file_args} "
            f"--pair {q}:{t} -o pair_{i:05d}.paf\n"
            for i, (q, t) in enumerate(pairs)
        ))
        print(f"Wrote {len(pairs)} alignment jobs", file=sys.stderr)
        return 0
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        n = align_mod.run_align(files, out, config, pairs=pairs)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"Wrote {n} alignment rows", file=sys.stderr)
    return 0


def _pansn(nm: str):
    """PanSN fields of a sequence name (sample#haplotype#contig, exactly
    three non-empty fields), or None."""
    parts = nm.split("#")
    if len(parts) == 3 and all(parts):
        return dict(sample=parts[0], haplotype=parts[1], contig=parts[2])
    return None


def cmd_render(args) -> int:
    """Render bundle (reference: render_bundle.rs:12 RenderManifest —
    rendered FASTA + regional graph + namespace table + manifest); the walk
    runs on the host engine, as in impg_tpu.cli."""
    import json

    from impg_tpu_torch.commands import render_translation as rt_mod
    from impg_tpu_torch.graph import region as region_mod
    from impg_tpu_torch.query import engine, merge as merge_mod, outputs
    from impg_tpu_torch.syng.index import SyngIndex

    index = _load_index(args)
    target_name, (start, end), name = bed_mod.parse_target_range(
        args.target_range
    )
    tid = index.seq_index.get_id(target_name)
    if tid is None:
        print(f"error: '{target_name}' not found in index", file=sys.stderr)
        return 1
    seq_idx = _sequence_index(args)
    merge_distance = bed_mod.parse_size(args.merge_distance)
    if args.transitive:
        results = engine.query_transitive_bfs(
            index, tid, start, end, max_depth=args.max_depth
        )
    else:
        results = engine.query(index, tid, start, end)
    merge_mod.merge_query_adjusted_intervals(results, merge_distance, True)

    prefix = args.output_prefix
    os.makedirs(prefix, exist_ok=True)
    with open(os.path.join(prefix, "render.fa"), "w") as fh:
        fasta_rows = [
            engine.Row(r.q_id, r.q_first, r.q_last, r.cigar, r.t_id,
                       r.t_first, r.t_last)
            for r in results
        ]
        outputs.write_fasta(
            index.seq_index, fasta_rows, fh, seq_idx, -1, False, False
        )
    if args.gfa_engine in ("seqwish", "pggb", "syng-native"):
        gfa_text = region_mod.generate_gfa_seqwish(
            index, results, seq_idx, engine=args.gfa_engine
        )
    else:
        gfa_text = region_mod.generate_gfa(index, results, seq_idx)
    with open(os.path.join(prefix, "render.gfa"), "w") as fh:
        fh.write(gfa_text)
    # One source interval a rendered path: (name, lo, hi, strand).
    spans = []
    for r in results:
        lo, hi = sorted((r.q_first, r.q_last))
        spans.append((index.seq_index.get_name(r.q_id), lo, hi,
                      "+" if r.q_first <= r.q_last else "-"))
    # Namespace table: rendered path name -> source sequence + range.
    with open(os.path.join(prefix, "namespace.tsv"), "w") as fh:
        fh.write("path\tsource\tstart\tend\tstrand\n")
        for src_name, lo, hi, strand in spans:
            fh.write(f"{src_name}:{lo}-{hi}\t{src_name}\t{lo}\t{hi}\t{strand}\n")
    # Structured namespace records (sequence_namespace.rs:21
    # SourceSequenceRecord + SourceInterval).
    src_ids: dict[int, int] = {}
    seq_records = []
    intervals = []
    for r, (nm, lo, hi, strand) in zip(results, spans):
        if r.q_id not in src_ids:
            src_ids[r.q_id] = len(src_ids)
            seq_records.append(
                dict(
                    id=src_ids[r.q_id],
                    name=nm,
                    length=int(index.seq_index.get_len_from_id(r.q_id)),
                    identity=dict(full_name=nm, pansn=_pansn(nm)),
                )
            )
        intervals.append(
            dict(source_sequence_id=src_ids[r.q_id], start=int(lo),
                 end=int(hi), strand=strand)
        )
    with open(os.path.join(prefix, "namespace.json"), "w") as fh:
        json.dump(
            dict(sequences=seq_records, intervals=intervals), fh, indent=2
        )
    # Regional syng index over the rendered interval sequences
    # (render_bundle.rs:24 syng_prefix).
    SyngIndex.build([
        (f"{nm}:{lo}-{hi}({strand})", seq_idx.fetch_sequence(nm, lo, hi))
        for nm, lo, hi, strand in spans
    ]).save(os.path.join(prefix, "region"))
    # Step-translation tables (render_bundle.rs:40 StepTranslationRecord):
    # every rendered path's graph steps back to source coordinates.
    rendered_paths = [
        rt_mod.RenderedPath(
            rendered_path_id=pid,
            rendered_name=f"{nm}:{iv['start']}-{iv['end']}",
            source_name=nm,
            source_sequence_id=iv["source_sequence_id"],
            start=iv["start"],
            end=iv["end"],
            strand=iv["strand"],
        )
        for pid, ((nm, _, _, _), iv) in enumerate(zip(spans, intervals))
    ]
    step_samples = rt_mod.collect_gfa_step_samples(gfa_text, rendered_paths)
    rt_mod.write_translation(prefix, rendered_paths, step_samples)
    with open(os.path.join(prefix, "manifest.json"), "w") as fh:
        json.dump(
            dict(
                format="impg-tpu-render-bundle",
                version=1,
                region=name,
                engine=args.gfa_engine,
                n_paths=len(results),
                rendered_paths=len(rendered_paths),
                step_samples=len(step_samples),
                syng_prefix="region",
                files=dict(
                    fasta="render.fa",
                    gfa="render.gfa",
                    namespace="namespace.tsv",
                    namespace_json="namespace.json",
                    translation="translation.npz",
                    translation_tsv="translation.tsv",
                    syng="region.syngt",
                ),
            ),
            fh,
            indent=2,
        )
    if args.render_graph:
        from impg_tpu_torch.graph.render_svg import render_svg

        with open(os.path.join(prefix, "render.svg"), "w") as fh:
            fh.write(render_svg(gfa_text))
    print(f"Render bundle -> {prefix}", file=sys.stderr)
    return 0


def cmd_project(args) -> int:
    from impg_tpu_torch.commands.project import run_project

    try:
        summary = run_project(
            gfa_path=args.gfa,
            gaf_path=args.gaf,
            output=args.output,
            output_format=args.output_format,
            feature_id_mode=args.graph_feature_id_mode,
            contribution_model=args.graph_contribution_model,
            read_contributions=args.read_contributions,
        )
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(
        f"Projected {summary['retained_records']}/{summary['total_records']} "
        f"GAF record(s), {summary['contributed_steps']} step(s) over "
        f"{summary['nonzero_features']} feature(s) "
        f"[graph {summary['graph_id']}, {summary['feature_id_mode']} ids] "
        f"-> {summary['output_path']}",
        file=sys.stderr,
    )
    return 0


def cmd_render_graph(args) -> int:
    from impg_tpu_torch.graph.render_svg import render_svg

    _write_out(args.output, render_svg(_read_gfa(args.gfa), width=args.width))
    return 0


def cmd_normalize_self_loops(args) -> int:
    import json

    from impg_tpu_torch.graph import selfloops
    from impg_tpu_torch.graph.gfa import Gfa

    text = _read_gfa(args.gfa)
    if args.diagnose:
        print(json.dumps(selfloops.diagnose(Gfa.parse(text)), indent=2))
        return 0
    out_text, stats = selfloops.normalize_self_loops(text, args.max_unit_len)
    _write_out(args.output, out_text)
    print(
        f"normalized {stats.normalized_nodes} nodes, collapsed "
        f"{stats.collapsed_runs} runs, removed "
        f"{stats.removed_self_loop_links} self-loop links",
        file=sys.stderr,
    )
    return 0


def cmd_normalize(args) -> int:
    from impg_tpu_torch.graph import normalize as norm_mod

    _write_out(args.output, norm_mod.normalize_gfa(_read_gfa(args.gfa)))
    return 0


def cmd_smooth(args) -> int:
    from impg_tpu_torch.graph import smooth as smooth_mod

    text = _read_gfa(args.gfa)
    scoring = _poa_scoring(args.poa_scoring)
    opts = dict(block_source=args.block_source, n_haps=args.n_haps,
                max_node_length=args.max_node_length)
    if args.poa_length:
        targets = [
            int(x) for x in args.poa_length.replace("/", ",").split(",") if x
        ]
        out_text = smooth_mod.smooth_gfa_passes(text, targets, scoring, **opts)
    else:
        out_text = smooth_mod.smooth_gfa(text, args.block_len, scoring, **opts)
    _write_out(args.output, out_text)
    return 0


def cmd_crush(args) -> int:
    from impg_tpu_torch.graph import crush as crush_mod

    out_text, st = crush_mod.crush_gfa(
        _read_gfa(args.gfa), max_span=args.max_span,
        max_rounds=args.max_rounds, scoring=_poa_scoring(args.poa_scoring),
    )
    print(
        f"crush: {st.rounds} rounds, {st.bubbles_resolved}/"
        f"{st.bubbles_seen} bubbles resolved, nodes "
        f"{st.nodes_before}->{st.nodes_after}, bp "
        f"{st.bp_before}->{st.bp_after}"
        + (f", {st.excluded_paths} paths excluded (no-op)"
           if st.excluded_paths and st.rounds == 0 else ""),
        file=sys.stderr,
    )
    _write_out(args.output, out_text)
    return 0


def cmd_graph(args, device: torch.device) -> int:
    """Flat whole-FASTA graph build (reference: Args::Graph main.rs:5427);
    partitioned mode runs this CLI's `partition -o gfa` on `device` (the
    run_graph_build_partitioned role)."""
    from impg_tpu_torch.commands import graph as graph_mod

    files = _comma_list(args.sequence_files)
    if not files:
        print(
            "error: no sequence files specified; use --sequence-files",
            file=sys.stderr,
        )
        return 2
    if args.partition_size:
        import shutil
        import tempfile

        paf = args.paf
        with tempfile.TemporaryDirectory() as tmp:
            if paf is None:
                paf = os.path.join(tmp, "aln.paf")
                seqs = graph_mod.load_sequences(files)
                rows = graph_mod.align_rows_native(
                    seqs, sparsify=args.sparsify
                )
                _write_paf_rows(paf, rows)
            rc = main(
                [
                    "partition", "-a", paf,
                    "-w", str(args.partition_size),
                    "-d", args.merge_distance,
                    "-o", "gfa",
                    "--sequence-files", ",".join(files),
                    "--output-folder", tmp,
                ],
                device=device,
            )
            if rc != 0:
                return rc
            src = os.path.join(tmp, "partitions.gfa")
            if args.output and args.output != "-":
                shutil.copyfile(src, args.output)
            else:
                with open(src) as fh:
                    sys.stdout.write(fh.read())
        return 0

    seqs = graph_mod.load_sequences(files)
    paf_rows = graph_mod.paf_rows_from_file(args.paf) if args.paf else None
    try:
        text = graph_mod.build_graph_flat(
            seqs,
            engine=args.gfa_engine,
            paf_rows=paf_rows,
            poa_scoring=_poa_scoring(args.poa_scoring),
            sparsify=args.sparsify,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    _write_out(args.output if args.output != "-" else None, text)
    return 0


def _write_paf_rows(path: str, rows: list) -> None:
    """Alignment row dicts (commands/align.py's shape) as PAF lines."""
    from impg_tpu_torch.core import cigar as cigar_mod

    with open(path, "w") as out:
        for row in rows:
            text = cigar_mod.format_runs(row["runs"])
            out.write(
                f"{row['qname']}\t{row['qlen']}\t{row['qstart']}"
                f"\t{row['qend']}\t{row['strand']}\t{row['tname']}"
                f"\t{row['tlen']}\t{row['tstart']}\t{row['tend']}"
                f"\t{row['matches']}\t{row['block']}\t255\tcg:Z:{text}\n"
            )


def cmd_agz(args) -> int:
    from impg_tpu_torch.io import agz as agz_mod

    if args.action == "create":
        if not args.output:
            print("error: agz create needs -o OUTPUT", file=sys.stderr)
            return 2
        stats = agz_mod.create_agz(args.output, args.files)
        print(
            f"Archived {stats['contigs']} contig(s) from "
            f"{stats['samples']} sample(s) -> {args.output}",
            file=sys.stderr,
        )
        return 0
    for f in args.files:
        arc = agz_mod.AgzArchive(f)
        try:
            for sample in arc.list_samples():
                for contig in arc.list_contigs(sample):
                    L = arc.get_sequence_length(f"{contig}@{sample}")
                    print(f"{sample}\t{contig}\t{L}")
        finally:
            arc.close()
    return 0


def cmd_gfa2vcf(args) -> int:
    from impg_tpu_torch.graph import vcf as vcf_mod

    text = _read_gfa(args.gfa)
    gen = (
        vcf_mod.gfa_to_vcf_flubbles
        if args.sites == "flubbles"
        else vcf_mod.gfa_to_vcf
    )
    # Multiple -r/--reference values call against each reference path in
    # turn (main.rs:5811 repeatable reference-name hints); records after
    # the first block reuse its header.
    for i, ref in enumerate(args.reference or [None]):
        out_text = gen(text, ref)
        if i > 0:
            out_text = "\n".join(
                l for l in out_text.splitlines() if not l.startswith("#")
            )
            if out_text:
                out_text += "\n"
        sys.stdout.write(out_text)
    return 0


def cmd_graph_report(args) -> int:
    """Graph characterization on the GFA columns (gfa_columns.report_columns,
    the same dict as the dict-model gfa.report); the port's tokenizer
    needs the native library, where impg_tpu falls back to the dict
    model."""
    from impg_tpu_torch.graph import gfa as gfa_mod
    from impg_tpu_torch.graph.gfa_columns import (parse_gfa_columns,
                                                  report_columns)

    text = _read_gfa(args.gfa)
    rep = report_columns(parse_gfa_columns(text))
    if not args.flubbles:
        sys.stdout.write(gfa_mod.report_text(rep, args.format))
        return 0
    from impg_tpu_torch.graph import bubbles as bubbles_mod

    refs = (
        [r for r in args.reference.split(",") if r]
        if args.reference
        else None
    )
    dec = bubbles_mod.decompose_flubbles(text, refs)
    class_counts: dict[str, int] = {}
    for site in dec.sites:
        class_counts[site.site_class] = class_counts.get(site.site_class, 0) + 1
    rep["flubbles"] = {
        "reference_path": dec.reference_path,
        "sites": len(dec.sites),
        "leaf_sites": dec.leaf_sites,
        "level_counts": {str(k): v for k, v in dec.level_counts().items()},
        "class_counts": class_counts,
    }
    sys.stdout.write(gfa_mod.report_text(rep, args.format))
    if args.format == "md":
        sys.stdout.write(
            bubbles_mod.architecture_text(dec, args.top_sites) + "\n"
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="impg_tpu_torch",
        description="Implicit pangenome query engine on PyTorch/CUDA",
    )
    ap.add_argument(
        "-v", "--verbosity", type=int, default=0, choices=[0, 1, 2],
        help="0 = errors, 1 = info (phase timings), 2 = debug "
        "(reference CommonOpts main.rs:2029 role)",
    )
    ap.add_argument(
        "-t", "--threads", type=int, default=4,
        help="Host worker threads for parallel sections (per-file index "
        "builds); device parallelism is independent "
        "(reference CommonOpts main.rs:2031 role)",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p_index = sub.add_parser("index", help="Build the alignment index")
    _add_common_query_opts(p_index)
    p_index.set_defaults(func=cmd_index)

    p_query = sub.add_parser("query", help="Query target ranges")
    _add_common_query_opts(p_query)
    p_query.add_argument("-r", "--target-range", help="seq_name:start-end")
    p_query.add_argument("-b", "--target-bed", help="BED file of target regions")
    p_query.add_argument(
        "-d",
        "--merge-distance",
        help="Merge ranges separated by at most D bp (k/m/g suffixes ok)",
    )
    p_query.add_argument("--no-merge", action="store_true")
    p_query.add_argument(
        "-o",
        "--output-format",
        default="bed",
        help="bed | bedpe | paf | fasta | fasta+paf | gfa | maf | "
        "fasta-aln | vcf | gfa:<stage>[,key=value...]:... (stages: cut-n, "
        "sort, sgd, smooth, normalize, crush, selfloops; no paf or "
        "fasta+paf for a .syngt index) | gbwt (a regional syng index at "
        "-O PREFIX)",
    )
    p_query.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_query.add_argument(
        "--gfa-engine", choices=["poa", "seqwish", "pggb", "syng-native"],
        default="poa",
        help="Graph engine for -o gfa|vcf (pggb = seqwish + the automatic "
        "sort/smooth/normalize chain, lib.rs:1015-1064)",
    )
    p_query.add_argument(
        "--reverse-complement",
        action="store_true",
        help="Reverse-complement reverse-strand sequences in FASTA output",
    )
    p_query.add_argument(
        "--sequence-files",
        action="append",
        help="FASTA file(s) for sequence-consuming outputs (repeat or "
        "comma-separate)",
    )
    p_query.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_query.add_argument(
        "-O", "--output",
        help="Output file (default stdout); prefix for -o gbwt",
    )
    p_query.add_argument("-x", "--transitive", action="store_true")
    p_query.add_argument("--transitive-dfs", action="store_true")
    p_query.add_argument("-m", "--max-depth", type=int, default=2)
    p_query.add_argument("--min-transitive-len", type=int, default=101)
    p_query.add_argument("--min-distance-between-ranges", type=int, default=10)
    p_query.add_argument("-l", "--min-output-length", type=int)
    p_query.add_argument("--min-result-identity", type=float)
    p_query.add_argument("--subset-sequence-list")
    p_query.add_argument("--original-sequence-coordinates", action="store_true")
    p_query.add_argument("--consider-strandness", action="store_true")
    p_query.add_argument(
        "--approximate",
        action="store_true",
        help="Tracepoint-only projection: intervals + identity without run "
        "slicing (bed/bedpe output only)",
    )
    _add_engine_opt(p_query)
    p_query.set_defaults(func=cmd_query)

    p_stats = sub.add_parser("stats", help="Index statistics")
    _add_common_query_opts(p_stats)
    p_stats.add_argument("--list-sequences", action="store_true")
    p_stats.add_argument(
        "-r", "--target-range",
        help="Report overlapping-record depth for one region "
        "(seq:start-end) instead of whole-index stats",
    )
    p_stats.add_argument(
        "-b", "--target-bed",
        help="Report overlapping-record depth per BED region",
    )
    _add_engine_opt(p_stats)
    p_stats.set_defaults(func=cmd_stats)

    p_part = sub.add_parser(
        "partition", help="Partition all genomes into homologous loci"
    )
    _add_common_query_opts(p_part)
    p_part.add_argument("-w", "--window-size", required=True)
    p_part.add_argument(
        "-d",
        "--merge-distance",
        help="Merge ranges separated by at most D bp before partition "
        "assignment (k/m/g suffixes ok)",
    )
    p_part.add_argument("--no-merge", action="store_true")
    p_part.add_argument("--starting-sequences-file")
    p_part.add_argument("--selection-mode", default="longest")
    p_part.add_argument("--min-missing-size", type=int, default=3000)
    p_part.add_argument("--min-boundary-distance", type=int, default=3000)
    p_part.add_argument("--separate-files", action="store_true")
    p_part.add_argument("--no-rehome-singletons", action="store_true")
    p_part.add_argument("--min-result-identity", type=float)
    p_part.add_argument("--transitive-dfs", action="store_true")
    p_part.add_argument("-m", "--max-depth", type=int, default=2)
    p_part.add_argument("--min-transitive-len", type=int, default=101)
    p_part.add_argument("--min-distance-between-ranges", type=int, default=10)
    p_part.add_argument(
        "-o", "--output-format", default="bed",
        choices=["bed", "paf", "fasta", "gfa", "maf", "vcf"],
    )
    p_part.add_argument("--sequence-files", action="append")
    p_part.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_part.add_argument("--output-folder")
    _add_engine_opt(p_part)
    p_part.set_defaults(func=cmd_partition)

    p_ref = sub.add_parser(
        "refine", help="Refine locus boundaries to maximize spanning support"
    )
    _add_common_query_opts(p_ref)
    p_ref.add_argument("-r", "--target-range")
    p_ref.add_argument("-b", "--target-bed")
    p_ref.add_argument("-d", "--merge-distance")
    p_ref.add_argument("--no-merge", action="store_true")
    p_ref.add_argument("--span-bp", type=int, default=1000)
    p_ref.add_argument("--max-extension", type=float, default=0.5)
    p_ref.add_argument("--extension-step", type=int, default=1000)
    p_ref.add_argument(
        "--pansn-mode", choices=["sequence", "sample", "haplotype"],
        default="sequence",
    )
    p_ref.add_argument("--support-output")
    p_ref.add_argument("--blacklist-bed")
    p_ref.add_argument("--min-result-identity", type=float)
    p_ref.add_argument("-x", "--transitive", action="store_true")
    p_ref.add_argument("--transitive-dfs", action="store_true")
    p_ref.add_argument("-m", "--max-depth", type=int, default=2)
    p_ref.add_argument("--min-transitive-len", type=int, default=101)
    p_ref.add_argument("--min-distance-between-ranges", type=int, default=10)
    p_ref.add_argument("--subset-sequence-list")
    _add_engine_opt(p_ref)
    p_ref.set_defaults(func=cmd_refine)

    p_sim = sub.add_parser(
        "similarity", help="Pairwise/group similarity over a region MSA"
    )
    _add_common_query_opts(p_sim)
    p_sim.add_argument("-r", "--target-range")
    p_sim.add_argument("-b", "--target-bed")
    p_sim.add_argument("-d", "--merge-distance")
    p_sim.add_argument("--no-merge", action="store_true")
    p_sim.add_argument("--sequence-files", action="append")
    p_sim.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_sim.set_defaults(_needs_sequences=True)
    p_sim.add_argument("--distances", action="store_true")
    p_sim.add_argument("--all", action="store_true", dest="emit_all_pairs")
    p_sim.add_argument("--delim")
    p_sim.add_argument("--delim-pos", type=int, default=1)
    p_sim.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_sim.add_argument("--pca", action="store_true")
    p_sim.add_argument("--pca-components", type=int, default=2)
    p_sim.add_argument(
        "--polarize-n-prev", type=int, default=0,
        help="Adaptive PCA sign polarization over N previous windows "
        "(0 disables)",
    )
    p_sim.add_argument(
        "--polarize-guide-samples",
        help="Comma-separated sample names anchoring PCA signs across "
        "windows (overrides --polarize-n-prev)",
    )
    p_sim.add_argument(
        "--pca-similarity", default="jaccard",
        choices=["jaccard", "cosine", "dice"],
    )
    p_sim.add_argument("--min-result-identity", type=float)
    p_sim.add_argument("-l", "--min-output-length", type=int)
    p_sim.add_argument("-x", "--transitive", action="store_true")
    p_sim.add_argument("--transitive-dfs", action="store_true")
    p_sim.add_argument("-m", "--max-depth", type=int, default=2)
    p_sim.add_argument("--min-transitive-len", type=int, default=101)
    p_sim.add_argument("--min-distance-between-ranges", type=int, default=10)
    p_sim.add_argument("--subset-sequence-list")
    _add_engine_opt(p_sim)
    p_sim.set_defaults(func=cmd_similarity)

    p_syng = sub.add_parser(
        "syng", help="Build a syncmer-anchor alignment-free index"
    )
    p_syng.add_argument(
        "-f", "--fasta-files", required=True, action="append",
        help="FASTA file(s) to index (repeat/comma-separate)",
    )
    p_syng.add_argument("-o", "--output", required=True, help="Index prefix")
    p_syng.add_argument("--syncmer-k", type=int, default=8)
    p_syng.add_argument("--syncmer-w", type=int, default=55)
    p_syng.add_argument("--syncmer-seed", type=int, default=7)
    _add_engine_opt(p_syng)
    p_syng.set_defaults(func=cmd_syng)

    p_map = sub.add_parser(
        "map", help="Map reads against a syng index into a pack"
    )
    p_map.add_argument("-a", "--alignment",
                       help="syng index prefix (or .syngt path)")
    p_map.add_argument(
        "--graph",
        help="Map against this GFA's path walks instead of a syng index "
        "(-o graph-pack -O FILE, graph-pack-tsv, gaf or paf; on the host)",
    )
    p_map.add_argument(
        "-q", "--reads", required=True, action="append",
        help="FASTA/FASTQ read file(s), optionally gzipped",
    )
    p_map.add_argument(
        "-o", "--output-format", default="pack",
        choices=["pack", "pack-tsv", "proj", "gaf", "graph-pack-tsv",
                 "graph-pack", "paf"],
        help="pack | pack-tsv | proj (bundle with the reads' GAF) | gaf | "
        "paf against a syng index; graph-pack | graph-pack-tsv | gaf | paf "
        "with --graph",
    )
    p_map.add_argument("-O", "--output",
                       help="Output path (default stdout for gaf)")
    p_map.add_argument(
        "--min-anchors", type=int, default=1,
        help="Minimum matched syncmer anchors to emit a mapping",
    )
    p_map.add_argument(
        "--chain-budget", type=int, default=10_000,
        help="Anchor chaining gap budget for -o paf",
    )
    p_map.add_argument(
        "--max-hits", type=int, default=0,
        help="Maximum PAF hits per query (0 = no limit)",
    )
    _add_engine_opt(p_map)
    p_map.set_defaults(func=cmd_map)

    p_gt = sub.add_parser(
        "genotype", help="Cosine genotyping of a locus from a pack"
    )
    p_gt.add_argument("method", choices=["cos", "cosigt"],
                      help="Scoring method")
    p_gt.add_argument("-a", "--alignment",
                      help="syng index prefix (or .syngt path)")
    p_gt.add_argument(
        "-p", "--pack", action="append",
        help="sample pack(s); repeat or comma-separate for a cohort — "
        "the candidate panel builds (and uploads) once and every "
        "sample scores against it; cohort packs need distinct file stems",
    )
    p_gt.add_argument("-r", "--target-range")
    p_gt.add_argument(
        "--graph",
        help="Genotype with gfa-segment features against this GFA (or a "
        "render bundle directory); -q reads or one -p pack (IMPGPKB1 or "
        "'#node_id<TAB>count' TSV)",
    )
    p_gt.add_argument("-q", "--reads", action="append",
                      help="Read files for --graph mode")
    p_gt.add_argument(
        "--target-path",
        help="Graph path (name[:start-end]) bounding --graph candidates",
    )
    p_gt.add_argument(
        "--contribution-model",
        choices=["raw", "length-normalized"],
        default="length-normalized",
    )
    p_gt.add_argument("--ploidy", type=int, default=2)
    p_gt.add_argument("--top-n", type=int, default=10)
    p_gt.add_argument("--max-combinations", type=int, default=1_000_000)
    p_gt.add_argument(
        "--candidate-mode", choices=["overlapping", "spanning"],
        default="overlapping",
    )
    p_gt.add_argument(
        "--sample-name",
        help="Sample column of a single pack's rows (default: sample); a "
        "cohort's rows are named by their packs' file stems",
    )
    _add_engine_opt(p_gt)
    p_gt.set_defaults(func=cmd_genotype)

    p_srt = sub.add_parser(
        "sort",
        help="Sort a GFA (Ygs: path-SGD 1D layout, groom, topological)",
    )
    p_srt.add_argument("gfa", help="GFA file (or - for stdin)")
    p_srt.add_argument(
        "--pipeline", default="Ygs",
        help="Steps: Y = path-SGD, g = groom, s = topological (default Ygs)",
    )
    p_srt.add_argument(
        "--sgd-backend", default="auto",
        choices=["auto", "numpy", "device", "jax"],
        help="Path-SGD engine: device (alias jax) = the K-I kernel on "
        "cuda:0, one launch per epoch; numpy = host; auto = device only "
        "when the update volume reaches 5e8 samples and CUDA is available",
    )
    p_srt.add_argument("--output", help="Output GFA (default stdout)")
    p_srt.set_defaults(func=cmd_sort)

    p_ri = sub.add_parser(
        "read-index", help="Build a read-syncmer inverted index"
    )
    p_ri.add_argument(
        "-q", "--reads", required=True, action="append",
        help="FASTA/FASTQ read file(s)",
    )
    p_ri.add_argument("-O", "--output", required=True, help="Index prefix")
    p_ri.add_argument("--syncmer-k", type=int, default=8)
    p_ri.add_argument("--syncmer-w", type=int, default=55)
    p_ri.add_argument("--syncmer-seed", type=int, default=7)
    p_ri.set_defaults(func=cmd_read_index)

    p_inf = sub.add_parser(
        "infer", help="Windowed allele inference with mosaic stitching"
    )
    p_inf.add_argument("-a", "--alignment", required=True,
                       help="syng index prefix (or .syngt path)")
    p_inf.add_argument("-p", "--pack", required=True)
    p_inf.add_argument("-r", "--target-range")
    p_inf.add_argument(
        "-b", "--target-bed",
        help="BED of regions/partitions: one windowed inference per row "
        "(infer.rs partitions-mode role)",
    )
    p_inf.add_argument("-w", "--window", type=int, default=5000)
    p_inf.add_argument("--ploidy", type=int, default=2)
    p_inf.add_argument("--top-n", type=int, default=5)
    p_inf.add_argument("--switch-penalty", type=float, default=0.1)
    p_inf.add_argument(
        "--candidate-mode", choices=["overlapping", "spanning"],
        default="overlapping",
    )
    p_inf.add_argument("--sample-name", default="sample")
    p_inf.add_argument(
        "--read-index",
        help=".readidx read-syncmer index for read-link rewards",
    )
    p_inf.add_argument("--read-link-weight", type=float, default=0.0)
    p_inf.add_argument("--min-read-link-anchors", type=int, default=3)
    p_inf.add_argument(
        "--gaf",
        help="syng-gaf-walk read GAF (from `map -o gaf`) for GBWT-MEM "
        "read-walk rewards (scaled by --read-link-weight)",
    )
    p_inf.add_argument(
        "--write-haplotypes", metavar="PREFIX",
        help="Write PREFIX_hapN.fa spelling the stitched mosaic "
        "(needs --sequence-files)",
    )
    p_inf.add_argument("--sequence-files", action="append")
    p_inf.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    # Accepted as in impg_tpu.cli; the scoring runs on the host.
    _add_engine_opt(p_inf)
    p_inf.set_defaults(func=cmd_infer)

    p_srep = sub.add_parser(
        "syng-repair",
        help="Validate/repair a .syngt artifact's derived state without "
        "re-reading source sequences",
    )
    p_srep.add_argument(
        "index", help="syng index prefix (or .syngt path)"
    )
    p_srep.add_argument(
        "--force", action="store_true",
        help="Rewrite the artifact even when already canonical",
    )
    p_srep.set_defaults(func=cmd_syng_repair)

    p_1a = sub.add_parser(
        "export-1aln",
        help="Export the alignment index as 1aln tracepoints "
        "(ASCII, or ONEcode binary container with --binary)",
    )
    _add_common_query_opts(p_1a)
    p_1a.add_argument("--spacing", type=int, default=100)
    p_1a.add_argument(
        "--binary", action="store_true",
        help="Write the ONEcode binary container ('A' records "
        "footer-indexed for O(1) fetch)",
    )
    p_1a.add_argument("-o", "--output", required=True)
    p_1a.set_defaults(func=cmd_export_1aln)

    p_tpa = sub.add_parser(
        "export-tpa",
        help="Export the alignment index as a binary TPA tracepoint "
        "container",
    )
    _add_common_query_opts(p_tpa)
    p_tpa.add_argument("--spacing", type=int, default=100)
    p_tpa.add_argument(
        "--tp-mode", choices=["fastga", "standard"], default="fastga",
        help="fastga: fixed-query-spacing (diffs, target_delta) pairs; "
        "standard: target-grid (query_delta, target_delta) pairs",
    )
    p_tpa.add_argument("-o", "--output", required=True)
    p_tpa.set_defaults(func=cmd_export_tpa)

    p_s2g = sub.add_parser(
        "syng2gfa",
        help="Dump a syng index as a blunt syncmer graph GFA "
        "(exact source-spelling paths)",
    )
    p_s2g.add_argument("-a", "--alignment", required=True,
                       help="syng index prefix (or .syngt path)")
    p_s2g.add_argument("--sequence-files", action="append")
    p_s2g.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_s2g.set_defaults(_needs_sequences=True)
    p_s2g.add_argument(
        "--drop-top-fraction", type=float, default=0.0005,
        help="Privatize this fraction of highest-frequency syncmers",
    )
    p_s2g.add_argument("--max-occurrences", type=int)
    p_s2g.add_argument(
        "--gfa-version", choices=["1.0", "1.1"], default="1.0",
        help="1.1 emits W walk lines instead of P lines",
    )
    p_s2g.add_argument(
        "--mode", choices=["blunt", "raw"], default="blunt",
        help="blunt: 0M links with truncated pieces; raw: native syng "
        "overlap graph (full RC-shared syncmer nodes, (k-offset)M links)",
    )
    p_s2g.add_argument(
        "--cut-ns", action="store_true",
        help="Drop ambiguous N-runs from fetched gap DNA and split emitted "
        "paths there (parts named NAME|partN); blunt mode only",
    )
    p_s2g.add_argument(
        "--cut-n-min-run", type=int, default=10,
        help="Minimum N-run length that triggers --cut-ns splitting",
    )
    p_s2g.add_argument("-o", "--output", help="Output GFA (default stdout)")
    p_s2g.set_defaults(func=cmd_syng2gfa)

    p_lace = sub.add_parser(
        "lace", help="Combine per-window GFAs (or VCFs) into one file"
    )
    p_lace.add_argument(
        "--gfa-files", action="append", help="GFA files (repeat/comma-separate)"
    )
    p_lace.add_argument("--gfa-list", help="File listing GFA paths, one per line")
    p_lace.add_argument(
        "--files", action="append",
        help="Input files, GFA or VCF (reference --files naming)",
    )
    p_lace.add_argument(
        "--file-list", help="File listing input paths, one per line"
    )
    p_lace.add_argument(
        "--format", choices=["gfa", "vcf", "auto"], default="auto",
        help="Input kind; auto = by first file's extension "
        "(main.rs determine_file_format)",
    )
    p_lace.add_argument("--output", required=True)
    p_lace.add_argument(
        "--fill-gaps", action="store_true",
        help="Fill inter-range gaps from --sequence-files",
    )
    p_lace.add_argument("--sequence-files", action="append")
    p_lace.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_lace.set_defaults(func=cmd_lace)

    p_aln = sub.add_parser(
        "align", help="All-vs-all alignment of FASTA sequences -> PAF"
    )
    p_aln.add_argument(
        "-f", "--fasta-files", required=True, action="append",
        help="FASTA file(s) (repeat/comma-separate)",
    )
    p_aln.add_argument("-o", "--output", help="Output PAF (default stdout)")
    p_aln.add_argument("--min-anchors", type=int, default=3)
    p_aln.add_argument("--max-gap", type=int, default=10_000)
    p_aln.add_argument("--min-chain-span", type=int, default=100)
    p_aln.add_argument(
        "--sparsify", default="none",
        help="Pair selection: none | random:P | knn:K (mash-sketch "
        "nearest groups, PanSN-aware)",
    )
    p_aln.add_argument("--mash-k", type=int, default=15)
    p_aln.add_argument("--sketch-size", type=int, default=1000)
    p_aln.add_argument(
        "--pair", action="append",
        help="Align only QUERY:TARGET (repeatable; job-list workers)",
    )
    p_aln.add_argument(
        "--run-joblist", metavar="FILE",
        help="Execute an existing joblist (one shell command per line) "
        "with parallel slots + progress",
    )
    p_aln.add_argument(
        "--jobs", type=int,
        help="Parallel slots for --run-joblist (default: CPU count)",
    )
    p_aln.add_argument(
        "--job-list", action="store_true",
        help="Emit one alignment command per selected pair instead of "
        "aligning (cluster execution)",
    )
    p_aln.add_argument("--scoring", default="1,4,6,2",
                       help="match,mismatch,gap_open,gap_ext")
    p_aln.set_defaults(func=cmd_align)

    p_rnd = sub.add_parser(
        "render", help="Write a local-graph render bundle for a region"
    )
    _add_common_query_opts(p_rnd)
    p_rnd.add_argument("-r", "--target-range", required=True)
    p_rnd.add_argument("-d", "--merge-distance", required=True)
    p_rnd.add_argument("--sequence-files", action="append")
    p_rnd.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_rnd.set_defaults(_needs_sequences=True)
    p_rnd.add_argument("-O", "--output-prefix", required=True,
                       help="Bundle directory")
    p_rnd.add_argument(
        "--gfa-engine", choices=["poa", "seqwish", "pggb", "syng-native"], default="poa"
    )
    p_rnd.add_argument("-x", "--transitive", action="store_true")
    p_rnd.add_argument("-m", "--max-depth", type=int, default=2)
    p_rnd.add_argument(
        "--render-graph", action="store_true",
        help="Also write render.svg (native SVG graph rendering)",
    )
    p_rnd.set_defaults(func=cmd_render)

    p_prj = sub.add_parser(
        "project",
        help="Project a GAF onto a GFA's segment feature space "
        "(pack TSV or projection bundle)",
    )
    p_prj.add_argument(
        "--gfa", "--graph", dest="gfa", required=True,
        help="GFA whose S-line names appear in the GAF walks",
    )
    p_prj.add_argument(
        "--gaf", required=True,
        help="GAF alignments with >segA<segB (or segA+,segB-) walks",
    )
    p_prj.add_argument(
        "-o", "--output-format", default="proj",
        help="proj (projection bundle) or pack-tsv",
    )
    p_prj.add_argument(
        "-O", "--output", required=True,
        help="Projection directory or pack TSV path",
    )
    p_prj.add_argument(
        "--read-contributions",
        help="Read-contribution table path for -o pack-tsv "
        "(bundles always include one)",
    )
    p_prj.add_argument(
        "--graph-feature-id-mode",
        choices=["auto", "dense", "segment-name"], default="auto",
        help="How S-line names map to integer pack feature IDs",
    )
    p_prj.add_argument(
        "--graph-contribution-model",
        choices=["raw", "length-normalized"], default="raw",
        help="Contribution model declared for graph-node evidence",
    )
    p_prj.set_defaults(func=cmd_project)

    p_rg = sub.add_parser(
        "render-graph", help="Render a GFA as SVG (depth-colored 1D layout)"
    )
    p_rg.add_argument("gfa", help="GFA file (or - for stdin)")
    p_rg.add_argument("--output", help="Output SVG (default stdout)")
    p_rg.add_argument("--width", type=int, default=1200)
    p_rg.set_defaults(func=cmd_render_graph)

    p_nsl = sub.add_parser(
        "normalize-self-loops",
        help="Collapse path-local repeat self-loop runs into run segments",
    )
    p_nsl.add_argument("gfa", help="GFA file (or - for stdin)")
    p_nsl.add_argument("--max-unit-len", type=int, default=0)
    p_nsl.add_argument("--diagnose", action="store_true",
                       help="Report self-loop statistics only")
    p_nsl.add_argument("--output", help="Output GFA (default stdout)")
    p_nsl.set_defaults(func=cmd_normalize_self_loops)

    p_norm = sub.add_parser(
        "normalize", help="GFAffix-style shared-affix normalization of a GFA"
    )
    p_norm.add_argument("gfa", help="GFA file (or - for stdin)")
    p_norm.add_argument("--output", help="Output GFA (default stdout)")
    p_norm.set_defaults(func=cmd_normalize)

    p_sm = sub.add_parser(
        "smooth", help="POA-smooth a GFA (sort -> blocks -> POA -> lace)"
    )
    p_sm.add_argument("gfa", help="GFA file (or - for stdin)")
    p_sm.add_argument("--block-len", type=int, default=1100)
    p_sm.add_argument(
        "-G", "--poa-length",
        help="Comma-separated multi-pass target POA lengths (pggb's "
        "-G 700,1100); overrides --block-len",
    )
    p_sm.add_argument(
        "--n-haps", type=int,
        help="Haplotype count for the block weight budget "
        "(max_block_weight = target * n_haps; default: path count)",
    )
    p_sm.add_argument(
        "--max-node-length", type=int, default=0,
        help="Chop nodes to this length before block decomposition "
        "(reference default 100; 0 = no chop)",
    )
    p_sm.add_argument(
        "--block-source", default="fixed", choices=["fixed", "flubble"],
        help="Block boundaries: fixed bp, or flubble-aware (never split "
        "a variation site)",
    )
    p_sm.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_sm.add_argument("--output", help="Output GFA (default stdout)")
    p_sm.set_defaults(func=cmd_smooth)

    p_gr = sub.add_parser(
        "graph",
        help="Build a whole-input pangenome graph from sequence files "
        "(align -> engine; or use a given PAF)",
    )
    p_gr.add_argument(
        "--sequence-files", "-f", action="append",
        help="FASTA file(s) (repeat or comma-separate)",
    )
    p_gr.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (alternative to "
        "--sequence-files)",
    )
    p_gr.add_argument(
        "-a", "--paf",
        help="Pre-computed PAF (skips the alignment step, main.rs:5433)",
    )
    p_gr.add_argument(
        "-g", "-o", "--output", default="-",
        help="Output GFA path ('-' = stdout)",
    )
    p_gr.add_argument(
        "--gfa-engine", default="seqwish",
        choices=["poa", "seqwish", "pggb", "syng-native"],
    )
    p_gr.add_argument(
        "--partition-size",
        help="Partitioned mode: partition into ~SIZE-bp loci, build each, "
        "lace (k/m/g suffixes ok)",
    )
    p_gr.add_argument(
        "-d", "--merge-distance", default="10k",
        help="Partitioned mode: merge ranges separated by at most D bp",
    )
    p_gr.add_argument(
        "--sparsify", default="none",
        help="Alignment pair sparsification: none|random:P|knn:K",
    )
    p_gr.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_gr.set_defaults(func=cmd_graph)

    p_agz = sub.add_parser(
        "agz",
        help="AGC-role compressed sequence archives (create from FASTA, "
        "list; usable wherever --sequence-files takes FASTA)",
    )
    p_agz.add_argument("action", choices=["create", "list"])
    p_agz.add_argument("files", nargs="+")
    p_agz.add_argument("-o", "--output")
    p_agz.set_defaults(func=cmd_agz)

    p_cr = sub.add_parser(
        "crush",
        help="Resolve anchor-bounded bubbles by POA realignment "
        "(path spellings preserved exactly)",
    )
    p_cr.add_argument("gfa", help="GFA file (or - for stdin)")
    p_cr.add_argument("--max-span", type=int, default=10_000)
    p_cr.add_argument("--max-rounds", type=int, default=4)
    p_cr.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_cr.add_argument("--output", help="Output GFA (default stdout)")
    p_cr.set_defaults(func=cmd_crush)

    p_vcf = sub.add_parser("gfa2vcf", help="Call variants from a GFA")
    p_vcf.add_argument("gfa", help="GFA file (or - for stdin)")
    p_vcf.add_argument(
        "-r", "--reference", action="append",
        help="Reference path name or prefix (repeatable; default: "
        "first path)",
    )
    p_vcf.add_argument(
        "--sites", default="anchors", choices=["anchors", "flubbles"],
        help="Site source: per-path anchor chains (biallelic records) or "
        "the flubble decomposition (multi-allelic site records)",
    )
    p_vcf.set_defaults(func=cmd_gfa2vcf)

    p_rep = sub.add_parser("graph-report", help="Characterize a GFA graph")
    p_rep.add_argument("gfa", help="GFA file (or - for stdin)")
    p_rep.add_argument(
        "--format", default="md", choices=["md", "json", "tsv"]
    )
    p_rep.add_argument(
        "--flubbles", action="store_true",
        help="Include nested variation-site (flubble) decomposition",
    )
    p_rep.add_argument(
        "--reference",
        help="Comma-separated reference path names/prefixes for the "
        "flubble decomposition (default: first path)",
    )
    p_rep.add_argument("--top-sites", type=int, default=5)
    p_rep.set_defaults(func=cmd_graph_report)
    return ap


# Subcommands that take no device.
_HOST_COMMANDS = (cmd_index, cmd_export_1aln, cmd_export_tpa, cmd_read_index,
                  cmd_syng2gfa, cmd_syng_repair, cmd_infer, cmd_lace,
                  cmd_align, cmd_render, cmd_project, cmd_render_graph,
                  cmd_normalize_self_loops, cmd_normalize, cmd_smooth,
                  cmd_crush, cmd_agz, cmd_gfa2vcf, cmd_graph_report)


def main(argv=None, device=None) -> int:
    """Run the port's CLI on `argv`.  `device` defaults to cuda:0; the tests
    pass "cpu"."""
    args = build_parser().parse_args(argv)
    # --sequence-list: file of sequence paths, normalized into
    # args.sequence_files so every downstream path sees one flag
    # (SequenceOpts::resolve_sequence_files, main.rs:4126).
    if getattr(args, "sequence_list", None):
        if getattr(args, "sequence_files", None):
            print(
                "error: cannot specify both --sequence-files and "
                "--sequence-list",
                file=sys.stderr,
            )
            return 2
        try:
            with open(args.sequence_list) as fh:
                args.sequence_files = [
                    l.strip()
                    for l in fh
                    if l.strip() and not l.strip().startswith("#")
                ]
        except OSError as e:
            print(
                f"error: failed to read sequence list file "
                f"'{args.sequence_list}': {e}",
                file=sys.stderr,
            )
            return 2
    if getattr(args, "_needs_sequences", False) and not getattr(
        args, "sequence_files", None
    ):
        print(
            "error: --sequence-files or --sequence-list is required",
            file=sys.stderr,
        )
        return 2
    import logging

    level = {0: logging.ERROR, 1: logging.INFO, 2: logging.DEBUG}[
        getattr(args, "verbosity", 0)
    ]
    logging.basicConfig(
        level=level, format="[%(levelname).1s %(name)s] %(message)s"
    )
    if getattr(args, "verbosity", 0) >= 2:
        # Debug level also turns on the C++ engine's per-phase span
        # accounting (stderr line per he_run; the reference's -v 2
        # Instant-logging role, CommonOpts main.rs:2029).
        os.environ.setdefault("IMPG_HE_PROF", "1")
    timed = getattr(args, "verbosity", 0) >= 1
    if timed:
        # Info level: the program's spans and counters (tracing.py), one
        # log line each at exit.
        tracing.reset()
        spans_were_on = tracing.enable()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    grouped = torch.distributed.is_available() and (
        torch.distributed.is_initialized())
    try:
        if args.func in _HOST_COMMANDS:
            return args.func(args)
        return args.func(args, dev)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0
    finally:
        if timed:
            log = logging.getLogger("impg_tpu_torch.tracing")
            for line in tracing.report():
                log.info(line)
            tracing.enable(spans_were_on)
        # A group that this run joined (--compute-engine mesh with
        # IMPG_COORDINATOR) ends with it.
        if not grouped and torch.distributed.is_available() and (
                torch.distributed.is_initialized()):
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
