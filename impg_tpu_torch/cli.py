"""Command line of the PyTorch/CUDA port.

The port's own CLI for `index`, `query`, `stats`, `partition`, `refine`,
`syng`, `map`, `genotype` and `sort`, with impg_tpu.cli's argument names,
defaults, messages and output bytes for them; it imports nothing of
impg_tpu.  `--compute-engine device|auto` runs the port's engines (for
`partition` and `refine -x`, one transitive walk a window or flank
candidate):

  * `TorchDeviceEngine`, resident on the card; built with tracepoints (and
    no CIGAR arena) for `--approximate` walks, which then run on the card
    too unless even those columns pass the device budget;
  * `TorchPagedEngine` (query/paged.py) for exact walks and `stats -r/-b`
    over an index whose lean bytes pass the device budget or whose arena
    passes 2^31 runs;
  * the syncmer kernels: `syng --compute-engine device` extracts with K-F,
    `map --compute-engine device` maps reads with K-G (`auto` keeps both on
    the host, as impg_tpu.cli does), and `genotype cos|cosigt` scores
    ploidy-2 pairs with the cuBLAS Gram and K-H (device: always; auto: past
    the FLOP crossover of genotype/core.auto_device_for_dense);
  * `sort --sgd-backend device` (alias `jax`) lays the graph out with the
    path-SGD kernel K-I; `auto` does so past impg_tpu's volume threshold of
    5e8 samples when CUDA is available, else runs the numpy loop, which
    writes impg_tpu's bytes.

Not yet ported, and refused with exit status 2 before any input is read:
every other subcommand of impg_tpu.cli; the FASTA, FASTA+PAF, GFA, MAF,
FASTA-aln, VCF and regional-syng (`gbwt`) outputs of `query`, and the
FASTA, GFA, MAF and VCF outputs and sequence files of `partition`;
`.syngt`, `.1aln` and `.tpa` alignment inputs; sequence-file lookups for
`--original-sequence-coordinates`; `map -o proj|gaf|paf|graph-pack|
graph-pack-tsv` and `map --graph`; `genotype --graph`; `--compute-engine
mesh`.

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
    "similarity", "lace", "align",
    "render", "read-index", "project", "render-graph",
    "normalize-self-loops", "normalize", "infer", "smooth", "graph",
    "syng-repair", "export-1aln", "export-tpa", "agz", "syng2gfa",
    "crush", "gfa2vcf", "graph-report",
)
# Output formats of impg_tpu.cli's `query` that the port has not ported
# (`gfa:<pipeline>` included).
UNPORTED_FORMATS = (
    "fasta", "fasta+paf", "gfa", "maf", "fasta-aln", "vcf", "gbwt",
)
UNPORTED_INPUTS = (".syngt", ".1aln", ".tpa")
# `partition` outputs of impg_tpu.cli that need the sequence and graph layers
# (and with them --sequence-files / --sequence-list).
UNPORTED_PARTITION_FORMATS = ("fasta", "gfa", "maf", "vcf")
# `map` outputs of impg_tpu.cli that need syng/map.py or the graph layer.
UNPORTED_MAP_FORMATS = ("proj", "gaf", "paf", "graph-pack", "graph-pack-tsv")
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


def cmd_partition(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import partition as partition_mod

    if args.merge_distance is None and not args.no_merge:
        print(
            "error: -d/--merge-distance is required. Use --no-merge to disable.",
            file=sys.stderr,
        )
        return 2
    merge_distance = -1 if args.no_merge else bed_mod.parse_size(args.merge_distance)
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


def _comma_list(entries) -> list[str]:
    return [x for e in (entries or []) for x in e.split(",") if x]


def _cuda_checked(args, device: torch.device) -> None:
    """Exit 2 for `--compute-engine mesh`, and for `device` on a CUDA device
    when CUDA is absent (as `query` does)."""
    spec = getattr(args, "compute_engine", "auto")
    if spec == "mesh":
        _fail("--compute-engine mesh is not yet ported to impg_tpu_torch")
    if spec == "device" and device.type == "cuda" \
            and not torch.cuda.is_available():
        _fail("--compute-engine device needs a CUDA device")


def cmd_syng(args, device: torch.device) -> int:
    from impg_tpu_torch.syng.index import SyngIndex

    _cuda_checked(args, device)
    files = _comma_list(args.fasta_files)
    # Build extraction: the threaded native kernel wins on one-shot builds,
    # so `auto` stays native; K-F runs on an explicit `device` (bit-exact
    # either way).
    on_device = args.compute_engine == "device"
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

    if args.output_format in UNPORTED_MAP_FORMATS or args.graph:
        what = "--graph" if args.graph else f"-o {args.output_format}"
        _fail(f"map {what} is not yet ported to impg_tpu_torch "
              "(ported: -o pack, pack-tsv against a syng index)")
    _cuda_checked(args, device)
    reads = _comma_list(args.reads)
    if not (args.alignment and args.output):
        print("error: map needs -a and -O (or --graph)", file=sys.stderr)
        return 2
    index = SyngIndex.load(args.alignment)
    if args.compute_engine == "device":
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
    else:
        pack.save(args.output)
    print(
        f"Mapped {n_reads} reads: {n_matched} syncmer matches over "
        f"{pack.feature_ids.size} features -> {args.output}",
        file=sys.stderr,
    )
    return 0


def _pack_stem(path: str) -> str:
    base = os.path.basename(path)
    return base.split(".")[0] or base


def cmd_genotype(args, device: torch.device) -> int:
    from impg_tpu_torch.commands import genotype as gt_mod
    from impg_tpu_torch.syng.index import SyngIndex
    from impg_tpu_torch.syng.pack import Pack

    if args.graph:
        _fail("genotype --graph is not yet ported to impg_tpu_torch "
              "(ported: the syng backend, -a/-p/-r)")
    _cuda_checked(args, device)
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
    spec = args.compute_engine
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
        # impg_tpu.cli's tristate: device -> True, auto -> None (the FLOP
        # crossover decides), host/native -> False.
        device={"device": True, "auto": None}.get(spec, False),
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

    if args.gfa == "-":
        text = sys.stdin.read()
    else:
        with open(args.gfa) as fh:
            text = fh.read()
    try:
        out_text = sortgfa_mod.sort_pipeline(
            text, args.pipeline, sgd_backend=args.sgd_backend, device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(out_text)
    else:
        sys.stdout.write(out_text)
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
        help="bed or paf (fasta, gfa, maf, vcf: not yet ported)",
    )
    p_part.add_argument("--sequence-files", action="append",
                        help="Not yet ported")
    p_part.add_argument(
        "--sequence-list",
        help="Text file listing sequence file paths (not yet ported)",
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
        "(not yet ported)",
    )
    p_map.add_argument(
        "-q", "--reads", required=True, action="append",
        help="FASTA/FASTQ read file(s), optionally gzipped",
    )
    p_map.add_argument(
        "-o", "--output-format", default="pack",
        choices=["pack", "pack-tsv", "proj", "gaf", "graph-pack-tsv",
                 "graph-pack", "paf"],
        help="pack | pack-tsv (the other formats of impg_tpu are not yet "
        "ported)",
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
        help="Genotype with gfa-segment features against this GFA "
        "(not yet ported)",
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
              "(ported: index, query, stats, partition, refine, syng, map, "
              "genotype, sort)")
    args = build_parser().parse_args(argv)
    if args.func is cmd_partition and (
            args.output_format in UNPORTED_PARTITION_FORMATS
            or args.sequence_files or args.sequence_list):
        _fail(f"partition -o {args.output_format} and sequence files are not "
              "yet ported to impg_tpu_torch (ported: -o bed, paf)")
    # index/query/stats take a list of alignment files (syng, map and
    # genotype take one syng index).
    alignments = (_alignment_files(args)
                  if isinstance(getattr(args, "alignment", None), list)
                  else [])
    for f in alignments:
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
