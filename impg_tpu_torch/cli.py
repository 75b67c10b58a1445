"""Command line of the PyTorch/CUDA port.

The port's own CLI for `index`, `query` and `stats`, with impg_tpu.cli's
argument names, defaults, messages and output bytes for them; it imports
nothing of impg_tpu.  `--compute-engine device|auto` runs the port's engines:

  * `TorchDeviceEngine`, resident on the card; built with tracepoints (and
    no CIGAR arena) for `--approximate` walks, which then run on the card
    too unless even those columns pass the device budget;
  * `TorchPagedEngine` (query/paged.py) for exact walks and `stats -r/-b`
    over an index whose lean bytes pass the device budget or whose arena
    passes 2^31 runs.

Not yet ported, and refused with exit status 2 before any input is read:
every other subcommand of impg_tpu.cli; the FASTA, FASTA+PAF, GFA, MAF,
FASTA-aln, VCF and regional-syng (`gbwt`) outputs of `query`; `.syngt`,
`.1aln` and `.tpa` inputs; sequence-file lookups for
`--original-sequence-coordinates`; `--compute-engine mesh`.

    python -m impg_tpu_torch.cli query -a aln.paf -r 'chr1:0-50000' -x \\
        -d 100 -o bed --compute-engine device

From the command line the device is always `cuda:0`.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from impg_tpu_torch.io import bed as bed_mod

# The subcommands of impg_tpu.cli that the port has not ported.
UNPORTED_COMMANDS = (
    "partition", "refine", "similarity", "lace", "align", "syng", "map",
    "genotype", "render", "read-index", "project", "render-graph",
    "normalize-self-loops", "normalize", "infer", "smooth", "graph",
    "syng-repair", "export-1aln", "export-tpa", "agz", "syng2gfa", "sort",
    "crush", "gfa2vcf", "graph-report",
)
# Output formats of impg_tpu.cli's `query` that the port has not ported
# (`gfa:<pipeline>` included).
UNPORTED_FORMATS = (
    "fasta", "fasta+paf", "gfa", "maf", "fasta-aln", "vcf", "gbwt",
)
UNPORTED_INPUTS = (".syngt", ".1aln", ".tpa")
# Global options of the parser that take a value (for finding the command).
_VALUE_OPTS = ("-v", "--verbosity", "-t", "--threads")


def _fail(msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(2)


def _add_engine_opt(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--compute-engine",
        choices=["host", "native", "device", "mesh", "auto"],
        default="auto",
        help="host: numpy engine; native: C++ transitive-BFS engine "
        "(default filter set only); device: the CUDA engine on cuda:0 "
        "(paged past the device budget); mesh: not yet ported; auto "
        "(default): the C++ engine for default-filter transitive queries, "
        "else device when CUDA is available and the index is non-toy, else "
        "host (IMPG_AUTO_MIN_RECORDS tunes the gate)",
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
    if args.no_bidirectional:
        # Bypass cache for non-default build flavor.
        return impg_index.ImpgIndex.from_paf_files(files, bidirectional=False)
    return impg_index.load_or_build(
        files, args.index, force=args.force_reindex,
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


def _original_length_lookup(args):
    """Original-frame sequence lengths for `--original-sequence-coordinates`
    PAF output (main.rs:4681 get_original_sequence_length): 0 with a warning,
    as without a sequence index (main() refuses sequence files here)."""
    if not getattr(args, "original_sequence_coordinates", False):
        return None

    def lookup(name: str) -> int:
        print(
            f"warning: no sequence index provided, using 0 as length "
            f"for sequence '{name}'",
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
    else TorchDeviceEngine.  auto ->
    native for default-filter walks, else device when `device` is a usable
    CUDA device and the index passes the IMPG_AUTO_MIN_RECORDS gate, else
    host.  mesh -> exits 2.
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
              "(paf/bedpe/fasta+paf); use host/device")
    if spec == "mesh":
        _fail("--compute-engine mesh is not yet ported to impg_tpu_torch")
    cuda = device.type == "cuda" and torch.cuda.is_available()
    if spec == "auto":
        if not cuda:
            return None
        n_records = len(getattr(index, "records", ())) or n_targets
        min_records = int(os.environ.get("IMPG_AUTO_MIN_RECORDS", "4096"))
        if n_records < min_records and n_targets < 64:
            return None
    if device.type == "cuda" and not cuda:
        _fail("--compute-engine device needs a CUDA device")
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

    fmt = args.output_format
    if fmt in UNPORTED_FORMATS or fmt.startswith("gfa:"):
        _fail(f"-o {fmt} is not yet ported to impg_tpu_torch "
              "(ported: bed, bedpe, paf)")
    valid_formats = {"bed", "bedpe", "paf"}
    if fmt not in valid_formats:
        print(
            f"error: invalid output format '{fmt}' "
            f"(choose from {', '.join(sorted(valid_formats))})",
            file=sys.stderr,
        )
        return 2
    if (fmt == "paf" and args.original_sequence_coordinates
            and args.sequence_files):
        _fail("sequence-file lengths for --original-sequence-coordinates are "
              "not yet ported to impg_tpu_torch")
    store_cigar = fmt in ("paf", "bedpe")
    if args.approximate and fmt not in ("bed", "bedpe"):
        print(
            f"error: --approximate mode is only compatible with 'bed' and "
            f"'bedpe' output formats, not '{fmt}'",
            file=sys.stderr,
        )
        return 2

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
    subset_match = subset.matches if subset else None

    out = open(args.output, "w") if args.output else sys.stdout
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
            else:
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
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


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
        help="bed | bedpe | paf (the sequence-backed formats of impg_tpu "
        "are not yet ported)",
    )
    # Options of the sequence-backed formats, accepted as impg_tpu.cli
    # accepts them and unused by bed/bedpe/paf.
    p_query.add_argument("--poa-scoring", default="1,4,6,2,26,1")
    p_query.add_argument(
        "--gfa-engine", choices=["poa", "seqwish", "pggb", "syng-native"],
        default="poa",
    )
    p_query.add_argument("--reverse-complement", action="store_true")
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
    p_query.add_argument("-O", "--output", help="Output file (default stdout)")
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
    return ap


def _command_of(argv: list[str]) -> str | None:
    """The subcommand named in `argv`: its first token that is not a global
    option or a global option's value."""
    skip = False
    for tok in argv:
        if skip:
            skip = False
        elif tok in _VALUE_OPTS:
            skip = True
        elif not tok.startswith("-"):
            return tok
    return None


def main(argv=None, device=None) -> int:
    """Run the port's CLI on `argv`.  `device` defaults to cuda:0; the tests
    pass "cpu"."""
    argv = sys.argv[1:] if argv is None else list(argv)
    command = _command_of(argv)
    if command in UNPORTED_COMMANDS:
        _fail(f"`{command}` is not yet ported to impg_tpu_torch "
              "(ported: index, query, stats)")
    args = build_parser().parse_args(argv)
    for f in _alignment_files(args):
        if f.endswith(UNPORTED_INPUTS):
            _fail(f"{f}: {os.path.splitext(f)[1]} input is not yet ported to "
                  "impg_tpu_torch (ported: PAF, PAF.gz)")
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
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    try:
        if args.func is cmd_index:
            return cmd_index(args)
        return args.func(args, dev)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(main())
