"""Region-level POA outputs: GFA, MAF, aligned FASTA.

The port's copy of impg_tpu/graph/region.py: the POA engine
(`generate_gfa`, `generate_maf`, `generate_fasta_aln`; tests/test_torch_poa.py
holds them equal) and `generate_gfa_seqwish`, the seqwish and syng-native
engines and the pggb chain on top (tests/test_torch_seqwish.py).  All of it
runs on the host after the walk: sequences, all-vs-all alignment over a host
syng index of the region, seqwish induction, the chain's sort, smooth and
normalize.

Functional parity with the reference's POA output path
(graph.rs:158-483 generate_gfa/maf/fasta_aln_from_intervals): query result
intervals -> strand-normalized sequences -> POA graph -> output format.
"""

from __future__ import annotations

from impg_tpu_torch.commands.similarity import SequenceMetadata, prepare_sequences
from impg_tpu_torch.graph import poa as poa_mod
from impg_tpu_torch.index.impg_index import ImpgIndex
from impg_tpu_torch.io.fasta import UnifiedSequenceIndex
from impg_tpu_torch.query.engine import Row


def region_poa(
    index: ImpgIndex,
    rows: list[Row],
    seq_idx: UnifiedSequenceIndex,
    scoring=poa_mod.DEFAULT_SCORING,
):
    pairs = prepare_sequences(index, rows, seq_idx)
    seqs = [p[0] for p in pairs]
    metadata = [p[1] for p in pairs]
    result = poa_mod.poa_align(seqs, scoring)
    return result, metadata


def _flip_reverse_paths(gfa: str, metadata: list[SequenceMetadata]) -> str:
    """Reverse-strand paths get reversed segment order + flipped orientations
    (reference: graph.rs post_process_gfa_for_strands)."""
    strand_map = {meta.path_name(): meta.strand for meta in metadata}
    out_lines = []
    for line in gfa.splitlines():
        if line.startswith("P\t"):
            parts = line.split("\t")
            if len(parts) >= 3 and strand_map.get(parts[1]) == "-":
                segs = parts[2].split(",")
                flipped = [
                    s[:-1] + ("-" if s.endswith("+") else "+")
                    for s in reversed(segs)
                ]
                parts[2] = ",".join(flipped)
                out_lines.append("\t".join(parts))
                continue
        out_lines.append(line)
    return "\n".join(out_lines) + "\n"


def generate_gfa(
    index: ImpgIndex,
    rows: list[Row],
    seq_idx: UnifiedSequenceIndex,
    scoring=poa_mod.DEFAULT_SCORING,
) -> str:
    result, metadata = region_poa(index, rows, seq_idx, scoring)
    names = [meta.path_name() for meta in metadata]
    gfa = poa_mod.poa_to_gfa(result, names)
    return _flip_reverse_paths(gfa, metadata)


def _trim_bounds(msa: list[str]) -> tuple[int, int]:
    if not msa or not msa[0]:
        return 0, 0
    n = len(msa[0])
    left, right = 0, n
    for i in range(n):
        if any(row[i] != "-" for row in msa):
            left = i
            break
    for i in range(n - 1, -1, -1):
        if any(row[i] != "-" for row in msa):
            right = i + 1
            break
    if right < left:
        return 0, n
    return left, right


def generate_gfa_seqwish(
    index: ImpgIndex,
    rows: list[Row],
    seq_idx: UnifiedSequenceIndex,
    scoring=None,
    engine: str = "seqwish",
    skip_normalize: bool = False,
) -> str:
    """Seqwish-engine region GFA: extract region sequences, all-vs-all align
    them natively, induce the variation graph (reference: GfaEngine::Seqwish,
    graph.rs:1058 -> commands/graph.rs build_graph).  engine="pggb" runs
    the reference's full automatic chain on top — line-sort, Ygs, smooth,
    gfaffix normalize, sort (lib.rs:1015-1064; graph/pggb.py) — with the
    normalize+final-sort skipped when the caller laces partitions
    (skip_normalize, lib.rs:1060)."""
    from impg_tpu_torch.commands import align as align_mod
    from impg_tpu_torch.graph import seqwish as seqwish_mod
    from impg_tpu_torch.syng.index import SyngIndex

    pairs = prepare_sequences(index, rows, seq_idx)
    seqs = {meta.path_name(): seq for seq, meta in pairs}
    syng = SyngIndex.build(list(seqs.items()))
    paf_rows = []
    names = list(seqs)
    for q in names:
        for t in names:
            if q != t:
                paf_rows.extend(
                    align_mod.align_sequence_pair(syng, seqs, q, t)
                )
    gfa = seqwish_mod.induce_graph(seqs, paf_rows)
    # induce_graph names paths `key:0-len`; the keys already carry region
    # coordinates, so strip the redundant suffix.
    fixed = []
    for line in gfa.splitlines():
        if line.startswith("P\t"):
            parts = line.split("\t")
            name = parts[1]
            base, _, suffix = name.rpartition(":")
            if suffix.startswith("0-") and base in seqs:
                parts[1] = base
            fixed.append("\t".join(parts))
        else:
            fixed.append(line)
    text = "\n".join(fixed) + "\n"
    if engine == "pggb":
        from impg_tpu_torch.graph.pggb import pggb_chain

        text = pggb_chain(
            text, scoring=scoring, skip_normalize=skip_normalize
        )
    return text


def generate_maf(
    index: ImpgIndex,
    rows: list[Row],
    seq_idx: UnifiedSequenceIndex,
    scoring=poa_mod.DEFAULT_SCORING,
) -> str:
    result, metadata = region_poa(index, rows, seq_idx, scoring)
    msa = result.msa
    left, right = _trim_bounds(msa)
    out = ["##maf version=1 scoring=impg_tpu_poa", "", "a score=0.0"]
    for row, meta in zip(msa, metadata):
        trimmed = row[left:right]
        aligned_size = sum(1 for c in trimmed if c != "-")
        out.append(
            f"s {meta.name} {meta.start} {aligned_size} {meta.strand} "
            f"{meta.total_length} {trimmed}"
        )
    out.append("")
    return "\n".join(out) + "\n"


def generate_fasta_aln(
    index: ImpgIndex,
    rows: list[Row],
    seq_idx: UnifiedSequenceIndex,
    scoring=poa_mod.DEFAULT_SCORING,
    line_width: int = 80,
) -> str:
    result, metadata = region_poa(index, rows, seq_idx, scoring)
    msa = result.msa
    left, right = _trim_bounds(msa)
    out = []
    for row, meta in zip(msa, metadata):
        trimmed = row[left:right]
        out.append(f">{meta.path_name()}")
        for i in range(0, len(trimmed), line_width):
            out.append(trimmed[i : i + line_width])
    return "\n".join(out) + "\n" if out else ""
