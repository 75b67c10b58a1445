"""Text output writers: BED, BEDPE, PAF, FASTA (reference: main.rs:11849-12110,
12351).

The port's copy of impg_tpu/query/outputs.py (tests/test_torch_host.py and
tests/test_torch_sequence.py hold the two equal), the regional syng (`-o
gbwt`) writers included (tests/test_torch_syng_tools.py).

Formatting details matched for bit-identical output:
  - BED: merged on the query axis (gap-2D first when rows lack CIGARs, i.e.
    always for BED since store_cigar=false), `name` column from the query
    region label, strand from interval orientation.
  - BEDPE/PAF: CIGAR-faithful 2D merge; gi/bi identities computed in float32
    and formatted with 6 decimals, trailing zeros trimmed.
"""

from __future__ import annotations

import re
from typing import Optional, TextIO

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.query import merge as merge_mod
from impg_tpu_torch.query.engine import Row

_SUBSEQ_RE = re.compile(r"^(.*):(\d+)-(\d+)$")


def parse_subsequence_coordinates(name: str) -> Optional[tuple[str, int]]:
    m = _SUBSEQ_RE.match(name)
    if not m:
        return None
    return m.group(1), int(m.group(2))


def transform_to_original(
    name: str, start: int, end: int, original_coordinates: bool
) -> tuple[str, int, int]:
    if not original_coordinates:
        return name, start, end
    parsed = parse_subsequence_coordinates(name)
    if parsed is None:
        return name, start, end
    orig_name, offset = parsed
    return orig_name, start + offset, end + offset


def _fmt_f32(value: np.float32) -> str:
    if np.isnan(value):
        return "NaN"  # Rust {:.6} casing (0/0 stats on CIGAR-less rows)
    s = f"{float(value):.6f}"
    return s.rstrip("0").rstrip(".")


def _cigar_stats(runs: Optional[np.ndarray]):
    """(matches, mismatches, i_count, i_bp, d_count, d_bp, block_len)."""
    if runs is None or runs.size == 0:
        return 0, 0, 0, 0, 0, 0, 0
    lens = cigar.run_len(runs).astype(np.int64)
    ops = cigar.run_op(runs)
    m = int(lens[(ops == cigar.OP_EQ) | (ops == cigar.OP_M)].sum())
    mm = int(lens[ops == cigar.OP_X].sum())
    icnt = int((ops == cigar.OP_I).sum())
    ibp = int(lens[ops == cigar.OP_I].sum())
    dcnt = int((ops == cigar.OP_D).sum())
    dbp = int(lens[ops == cigar.OP_D].sum())
    bl = int(lens.sum())
    return m, mm, icnt, ibp, dcnt, dbp, bl


def write_bed(
    seq_index: SequenceIndex,
    results: list[Row],
    out: TextIO,
    name: str,
    merge_distance: int,
    merge_strands: bool,
    original_coordinates: bool = False,
) -> None:
    any_empty = any(r.cigar is None or r.cigar.size == 0 for r in results)
    if any_empty:
        merge_mod.merge_adjusted_intervals_gap_2d(results, merge_distance)
    merge_mod.merge_query_adjusted_intervals(results, merge_distance, merge_strands)
    for row in results:
        qname = seq_index.get_name(row.q_id)
        if row.q_first <= row.q_last:
            first, last, strand = row.q_first, row.q_last, "+"
        else:
            first, last, strand = row.q_last, row.q_first, "-"
        tname, tfirst, tlast = transform_to_original(
            qname, first, last, original_coordinates
        )
        out.write(f"{tname}\t{tfirst}\t{tlast}\t{name}\t.\t{strand}\n")


def write_bedpe(
    seq_index: SequenceIndex,
    results: list[Row],
    out: TextIO,
    name: str,
    merge_distance: int,
    original_coordinates: bool = False,
) -> None:
    any_empty = any(r.cigar is None or r.cigar.size == 0 for r in results)
    if any_empty:
        merge_mod.merge_adjusted_intervals_gap_2d(results, merge_distance)
    else:
        merge_mod.merge_adjusted_intervals(results, merge_distance)
    for row in results:
        qname = seq_index.get_name(row.q_id)
        tname = seq_index.get_name(row.t_id)
        if row.q_first <= row.q_last:
            first, last, strand = row.q_first, row.q_last, "+"
        else:
            first, last, strand = row.q_last, row.q_first, "-"
        oq_name, oq_first, oq_last = transform_to_original(
            qname, first, last, original_coordinates
        )
        ot_name, ot_first, ot_last = transform_to_original(
            tname, row.t_first, row.t_last, original_coordinates
        )
        m, mm, icnt, ibp, dcnt, dbp, _bl = _cigar_stats(row.cigar)
        with np.errstate(divide="ignore", invalid="ignore"):
            gci = np.float32(m) / np.float32(m + mm + icnt + dcnt)
            bi = np.float32(m) / np.float32(m + mm + ibp + dbp)
        out.write(
            f"{oq_name}\t{oq_first}\t{oq_last}\t{ot_name}\t{ot_first}\t{ot_last}"
            f"\t{name}\t0\t{strand}\t+\tgi:f:{_fmt_f32(gci)}\tbi:f:{_fmt_f32(bi)}\n"
        )


def write_fasta(
    seq_index: SequenceIndex,
    results: list[Row],
    out: TextIO,
    sequence_index,
    merge_distance: int,
    merge_strands: bool,
    reverse_complement_flag: bool = False,
) -> None:
    """FASTA of the merged result regions (reference: main.rs:12351)."""
    from impg_tpu_torch.io.fasta import reverse_complement

    merge_mod.merge_query_adjusted_intervals(results, merge_distance, merge_strands)
    for row in results:
        qname = seq_index.get_name(row.q_id)
        if row.q_first <= row.q_last:
            start, end, strand = row.q_first, row.q_last, "+"
        else:
            start, end, strand = row.q_last, row.q_first, "-"
        seq = sequence_index.fetch_sequence(qname, start, end)
        suffix = ""
        if strand == "-" and reverse_complement_flag:
            seq = reverse_complement(seq)
            suffix = "/rc"
        out.write(f">{qname}:{start}-{end}{suffix}\n")
        text = seq.decode()
        for i in range(0, len(text), 80):
            out.write(text[i : i + 80] + "\n")


def write_paf(
    seq_index: SequenceIndex,
    results: list[Row],
    out: TextIO,
    name: str,
    merge_distance: int,
    original_coordinates: bool = False,
    original_length_lookup=None,
) -> None:
    merge_mod.merge_adjusted_intervals(results, merge_distance)
    for row in results:
        qname = seq_index.get_name(row.q_id)
        tname = seq_index.get_name(row.t_id)
        if row.q_first <= row.q_last:
            first, last, strand = row.q_first, row.q_last, "+"
        else:
            first, last, strand = row.q_last, row.q_first, "-"
        oq_name, oq_first, oq_last = transform_to_original(
            qname, first, last, original_coordinates
        )
        ot_name, ot_first, ot_last = transform_to_original(
            tname, row.t_first, row.t_last, original_coordinates
        )
        if original_coordinates and original_length_lookup is not None:
            q_len = original_length_lookup(oq_name)
            t_len = original_length_lookup(ot_name)
        else:
            q_len = seq_index.get_len_from_id(row.q_id)
            t_len = seq_index.get_len_from_id(row.t_id)
        m, mm, icnt, ibp, dcnt, dbp, bl = _cigar_stats(row.cigar)
        with np.errstate(divide="ignore", invalid="ignore"):
            gci = np.float32(m) / np.float32(m + mm + icnt + dcnt)
            bi = np.float32(m) / np.float32(m + mm + ibp + dbp)
        cigar_str = cigar.format_runs(row.cigar) if row.cigar is not None else ""
        out.write(
            f"{oq_name}\t{q_len}\t{oq_first}\t{oq_last}\t{strand}"
            f"\t{ot_name}\t{t_len}\t{ot_first}\t{ot_last}"
            f"\t{m}\t{bl}\t255\tgi:f:{_fmt_f32(gci)}\tbi:f:{_fmt_f32(bi)}"
            f"\tcg:Z:{cigar_str}\tan:Z:{name}\n"
        )


def collect_region_sequences(
    seq_index: SequenceIndex,
    results: list[Row],
    sequence_index,
    merge_distance: int,
) -> list[tuple[str, bytes]]:
    """Fetch the merged result intervals as named sequences
    `genome:start-end(strand)` — the input set for a regional syng index
    (reference main.rs:7188 `-o gbwt` interval fetch)."""
    merge_mod.merge_query_adjusted_intervals(results, merge_distance, False)
    sequences = []
    for row in results:
        qname = seq_index.get_name(row.q_id)
        if row.q_first <= row.q_last:
            start, end, strand = row.q_first, row.q_last, "+"
        else:
            start, end, strand = row.q_last, row.q_first, "-"
        seq = sequence_index.fetch_sequence(qname, start, end)
        sequences.append((f"{qname}:{start}-{end}({strand})", seq))
    return sequences


def write_region_gbwt(
    sequences: list[tuple[str, bytes]],
    prefix: str,
    k: int | None = None,
    w: int | None = None,
    seed: int | None = None,
) -> str:
    """Build + save a regional syng index over fetched region sequences
    (syng.rs:5263 build_region_gbwt).  The reference writes ONEcode
    `.1khash`/`.1gbwt` containers; here the single `.syngt` artifact
    carries the occurrence table the GBWT-lite derives its walk structure
    from (syng/gbwt.py), so one file serves both roles."""
    from impg_tpu_torch.syng.index import SyngIndex

    kwargs = {}
    if k is not None:
        kwargs["k"] = k
    if w is not None:
        kwargs["w"] = w
    if seed is not None:
        kwargs["seed"] = seed
    region_index = SyngIndex.build(sequences, **kwargs)
    return region_index.save(prefix)
