"""Lace per-window VCFs into one genome-frame VCF.

Reference: lace.rs:1404 ``run_vcf_lace``.  Per-window VCFs (as written by
``query -o vcf`` / partitioned VCF builds) carry the window frame in the
CHROM column as ``NAME:START-END``; lacing lifts every record back to the
base contig (``POS += START``), unions the sample columns across files
(sorted; missing genotypes filled with ``./.`` for GT and ``.`` for other
FORMAT keys — lace.rs:1823), regenerates ``##contig`` lines from the
observed window ends (or true lengths from an optional reference index —
lace.rs:1727), and orders files by their smallest (chromosome, start) key
using the human-friendly chr ordering of lace.rs:1371 ``chr_sort_key``.

Unlike the reference this is a single pass per file on the host (the scan
is metadata-only and IO-bound; there is no device work to map).

The port's copy of impg_tpu/graph/vcf_lace.py, behind `lace` of VCFs
(tests/test_torch_graph_cmd.py holds the text equal).
"""

from __future__ import annotations

import gzip
from typing import Optional


def parse_vcf_chrom(chrom: str) -> Optional[tuple[str, int, int]]:
    """Split a window-frame CHROM ``NAME:START-END`` (last-':' split like
    lace.rs:1353; NAME may itself contain ':')."""
    colon = chrom.rfind(":")
    if colon < 0:
        return None
    base, rng = chrom[:colon], chrom[colon + 1:]
    dash = rng.find("-")
    if dash < 0:
        return None
    try:
        return base, int(rng[:dash]), int(rng[dash + 1:])
    except ValueError:
        return None


def chr_sort_key(base_contig: str) -> tuple[int, int, str]:
    """Human-friendly chromosome ordering (lace.rs:1371): chr1..22 < X <
    Y < M/MT < everything else alphabetically; PanSN prefixes ignored."""
    label = base_contig.split("#")[-1]
    if label.startswith("chr"):
        suffix = label[3:]
        if suffix.isdigit() and 1 <= int(suffix) <= 22:
            return (0, int(suffix), "")
        if suffix == "X":
            return (0, 23, "")
        if suffix == "Y":
            return (0, 24, "")
        if suffix in ("M", "MT"):
            return (0, 25, "")
    return (1, 0, label)


def _open_text(path: str):
    """Transparent gzip/plain text reader (niffler role, lace.rs:1603)."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


def _scan_file(path: str):
    """First pass: samples, per-contig max window end, file order key
    (lace.rs:1530 process_vcf_file)."""
    samples: list[str] = []
    contig_max: dict[str, int] = {}
    order: Optional[tuple] = None
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                parts = line.split("\t")
                if len(parts) > 9:
                    samples = parts[9:]
                continue
            parts = line.split("\t")
            if len(parts) < 2:
                continue
            parsed = parse_vcf_chrom(parts[0])
            if parsed is None:
                raise ValueError(
                    f"Unexpected CHROM format in {path}: {parts[0]} "
                    "(expected NAME:START-END window frames)"
                )
            base, start, end = parsed
            try:
                int(parts[1])
            except ValueError:
                continue
            if end > contig_max.get(base, 0):
                contig_max[base] = end
            k = chr_sort_key(base)
            key = (k[0], k[1], k[2], start)
            if order is None or key < order:
                order = key
    return samples, contig_max, order or (2, 0, "", 0)


def _merge_records(path: str, merged_samples: list[str], out: list[str]) -> None:
    """Second pass: lift records to the base frame and reorder genotype
    columns (lace.rs:1782 merge_vcf_file_records)."""
    this_samples: list[str] = []
    missing_cache: dict[str, str] = {}
    with _open_text(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if line.startswith("#CHROM"):
                    parts = line.split("\t")
                    if len(parts) > 9:
                        this_samples = parts[9:]
                continue
            parts = line.split("\t")
            if len(parts) < 9:
                raise ValueError(f"Malformed VCF record in {path}: {line}")
            parsed = parse_vcf_chrom(parts[0])
            if parsed is None:
                raise ValueError(
                    f"Unexpected CHROM format in {path}: {parts[0]}"
                )
            base, start, _end = parsed
            new_pos = start + int(parts[1])
            fmt = parts[8]
            missing = missing_cache.get(fmt)
            if missing is None:
                missing = ":".join(
                    "./." if key == "GT" else "." for key in fmt.split(":")
                )
                missing_cache[fmt] = missing
            gt_of = dict(zip(this_samples, parts[9:]))
            row = [base, str(new_pos), *parts[2:9]]
            row.extend(gt_of.get(s, missing) for s in merged_samples)
            out.append("\t".join(row))


def lace_vcfs(files: list[str], reference_index=None) -> str:
    """Merge per-window VCFs into one genome-frame VCF string
    (lace.rs:1404 run_vcf_lace; compression is the CLI's concern)."""
    if not files:
        raise ValueError("No VCF files specified")
    all_samples: set[str] = set()
    contig_max: dict[str, int] = {}
    ordered: list[tuple[tuple, str]] = []
    for path in files:
        samples, contigs, order = _scan_file(path)
        all_samples.update(samples)
        for base, end in contigs.items():
            if end > contig_max.get(base, 0):
                contig_max[base] = end
        ordered.append((order, path))
    merged_samples = sorted(all_samples)
    ordered.sort(key=lambda t: t[0])
    sorted_paths = [p for _, p in ordered]

    lines: list[str] = ["##fileformat=VCFv4.2"]
    # meta lines from the first (sorted) file, minus fileformat/contig
    with _open_text(sorted_paths[0]) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith("##"):
                if line.startswith("##fileformat") or line.startswith(
                    "##contig"
                ):
                    continue
                lines.append(line)
            else:
                break
    for base in sorted(contig_max, key=chr_sort_key):
        length = contig_max[base]
        if reference_index is not None:
            try:
                length = reference_index.get_sequence_length(base)
            except (KeyError, ValueError):
                pass
        lines.append(f"##contig=<ID={base},length={length}>")
    lines.append("\t".join(
        ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
         "FORMAT", *merged_samples]
    ))
    for path in sorted_paths:
        _merge_records(path, merged_samples, lines)
    return "\n".join(lines) + "\n"
