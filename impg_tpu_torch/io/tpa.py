"""TPA binary tracepoint-alignment container: writer + reader.

Role model: the reference's `tpa` crate usage (tpa_parser.rs:32 TpaParser /
:134 fetch_alignment).  The upstream container is a BGZF stream with a
header (tp_type, complexity_metric, max_complexity, distance), a string
table, compact per-record metadata with O(1) record seek, and per-record
tracepoint payloads in five encodings (TracepointData: Standard / Fastga /
FastgaNoDiff / Variable / Mixed).  The crate's byte layout is not published
inside the reference repo, so this module defines an equivalent binary
container with the same data model on the flat-tensor layout the rest of
the framework uses:

  * one compressed npz holds the header, the name table, the record
    metadata as SoA arrays (the whole metadata block loads as tensors in a
    single read — the role of the compact-record metadata iterator,
    tpa_parser.rs:71), and every record's tracepoint items concatenated
    with an offsets array (O(1) per-record slicing — the role of
    record-id seeking, tpa_parser.rs:116);
  * the five tracepoint encodings are preserved per record as
    (kind, a, b) item triples; CIGAR-op items of the Mixed encoding carry
    the op so ingest can replay them literally.

Coordinates are PAF-style scaffold coordinates (tpa_parser.rs:103).
Ingest reconstructs CIGARs per trace segment exactly like the 1aln path
(io/onealn.py reconstruct_runs): approximate interior without sequences,
native-Gotoh exact runs with them.

The port's copy of impg_tpu/io/tpa.py (tests/test_torch_tpa.py holds the two
equal by loaded arrays: the container is a zip whose bytes carry times).
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.io.onealn import reconstruct_runs, reconstruct_runs_batch

TPA_SUFFIX = ".tpa"
FORMAT_VERSION = 1

TP_TYPES = ("standard", "fastga", "fastga-nodiff", "variable", "mixed")

# Item kinds in the concatenated tracepoint stream.
KIND_PAIR = 0  # (a, b) tracepoint pair; meaning depends on tp_type
KIND_CIGAR = 1  # (op_code, length) literal CIGAR op (Mixed encoding)

_OP_OF_CHAR = {"=": cigar.OP_EQ, "X": cigar.OP_X, "I": cigar.OP_I,
               "D": cigar.OP_D, "M": cigar.OP_EQ}


def _run_axes(runs: np.ndarray):
    """(q_advance, t_advance, diff_bp) per packed run."""
    lens = cigar.run_len(runs).astype(np.int64)
    ops = cigar.run_op(runs).astype(np.int64)
    consumes_q = ops != cigar.OP_D
    consumes_t = ops != cigar.OP_I
    is_diff = (ops == cigar.OP_X) | (ops == cigar.OP_I) | (ops == cigar.OP_D)
    return lens * consumes_q, lens * consumes_t, lens * is_diff


def _fastga_first_boundary(spacing: int, qs: int, qe: int, rev: bool) -> int:
    """Walk-relative offset of the first query-grid boundary.

    The reference anchors the fixed-query grid at ABSOLUTE multiples of
    spacing (impg.rs:717 first_boundary = ((qs/ts)+1)*ts - qs), not at the
    alignment start.  Forward walks start at qs; reverse-strand walks run
    from qe downward, so their first boundary is the distance down to the
    largest multiple strictly below qe.
    """
    if rev:
        return qe - ((qe - 1) // spacing) * spacing if qe > 0 else spacing
    return ((qs // spacing) + 1) * spacing - qs


def _fastga_segments(runs: np.ndarray, spacing: int, qs: int, qe: int,
                     rev: bool):
    """(diffs, t_delta) per fixed-QUERY-spacing segment (the tpa Fastga
    encoding: pairs (num_diffs, target_delta), tpa_parser.rs:164), with
    the grid anchored at absolute multiples of spacing."""
    if runs.size == 0:
        # Degenerate record (no CIGAR runs): nothing to segment; the
        # bound-to-run search below would index an empty array otherwise.
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    dq, dt, dd = _run_axes(runs)
    cq = np.concatenate([[0], np.cumsum(dq)])
    ct = np.concatenate([[0], np.cumsum(dt)])
    cd = np.concatenate([[0], np.cumsum(dd)])
    total_q = int(cq[-1])
    first = min(_fastga_first_boundary(spacing, qs, qe, rev), total_q)
    if total_q <= first:
        bounds = np.asarray([total_q], np.int64)
    else:
        interior = np.arange(first, total_q, spacing, dtype=np.int64)
        bounds = np.concatenate([interior, [total_q]])
    # Run containing each query boundary: last run start <= b.
    j = np.searchsorted(cq[1:], bounds, side="left")
    j = np.minimum(j, len(dq) - 1)
    frac = bounds - cq[j]
    ops = cigar.run_op(runs).astype(np.int64)
    consumes_t = (ops != cigar.OP_I)[j]
    is_x = (ops == cigar.OP_X)[j]
    is_i = (ops == cigar.OP_I)[j]
    t_at = ct[j] + np.where(consumes_t, frac, 0)
    d_at = cd[j] + np.where(is_x | is_i, frac, 0)
    t_at = np.concatenate([[0], t_at])
    d_at = np.concatenate([[0], d_at])
    return np.diff(d_at), np.diff(t_at)


def _standard_segments(tp, r: int):
    """Per-segment query advances from the target-grid tracepoint arena
    (the standard encoding's `a` values; the caller synthesizes the
    target deltas from the fixed target grid)."""
    off = int(tp.seg_off[r])
    nseg = int(tp.n_seg[r])
    qb = tp.q_bound[off : off + nseg + 1].astype(np.int64)
    return np.abs(np.diff(qb))


def write_tpa(
    path: str,
    seq_index: SequenceIndex,
    records,
    arena,
    tp,
    tp_type: str = "fastga",
    complexity_metric: str = "edit",
    distance: str = "edit",
) -> int:
    """Write the non-reversed directed records as a TPA container.

    `fastga` resegments each record's runs on a fixed-query-spacing grid
    (pairs = (diffs, target_delta)); `standard` reuses the target-grid
    tracepoint arena (pairs = (query_delta, target_delta), no diffs).
    """
    if tp_type not in ("standard", "fastga"):
        raise ValueError(f"unsupported tp_type for export: {tp_type}")
    spacing = tp.spacing
    rec_sel = []
    # Each record's items as arrays, concatenated once.
    tp_a: list[np.ndarray] = []
    tp_b: list[np.ndarray] = []
    tp_off = [0]
    for r in range(len(records)):
        if bool(records.is_reversed[r]):
            continue
        rec_sel.append(r)
        off = int(records.op_off[r])
        cnt = int(records.op_cnt[r])
        runs = arena.runs[off : off + cnt]
        if tp_type == "fastga":
            diffs, t_deltas = _fastga_segments(
                runs, spacing,
                int(records.q_start[r]), int(records.q_end[r]),
                int(records.strand[r]) == 1,
            )
            tp_a.append(np.asarray(diffs, np.int64))
            tp_b.append(np.asarray(t_deltas, np.int64))
            n_items = len(diffs)
        else:
            q_deltas = _standard_segments(tp, r)
            nseg = int(tp.n_seg[r])
            ts = int(records.t_start[r])
            te = int(records.t_end[r])
            bounds = np.minimum(
                ts + np.arange(nseg + 1, dtype=np.int64) * spacing, te
            )
            bounds[-1] = te
            t_deltas = np.diff(bounds)
            tp_a.append(np.asarray(q_deltas, np.int64))
            tp_b.append(np.asarray(t_deltas, np.int64))
            n_items = len(q_deltas)
        tp_off.append(tp_off[-1] + n_items)

    names, lengths = seq_index.to_arrays()
    sel = np.asarray(rec_sel, np.int64)
    out = path if path.endswith(TPA_SUFFIX) else path + TPA_SUFFIX
    np.savez_compressed(
        out if out.endswith(".npz") else out + ".npz",
        version=np.int64(FORMAT_VERSION),
        tp_type=np.str_(tp_type),
        complexity_metric=np.str_(complexity_metric),
        max_complexity=np.int64(spacing),
        distance=np.str_(distance),
        names=names.astype(str),
        lengths=np.asarray(lengths, np.int64),
        query_id=records.query_id[sel].astype(np.int32),
        target_id=records.target_id[sel].astype(np.int32),
        strand=records.strand[sel].astype(np.int8),
        q_start=records.q_start[sel].astype(np.int64),
        q_end=records.q_end[sel].astype(np.int64),
        t_start=records.t_start[sel].astype(np.int64),
        t_end=records.t_end[sel].astype(np.int64),
        tp_kind=np.full(tp_off[-1], KIND_PAIR, np.uint8),
        tp_a=_cat_items(tp_a),
        tp_b=_cat_items(tp_b),
        tp_off=np.asarray(tp_off, np.int64),
    )
    import os

    if not out.endswith(".npz") and os.path.exists(out + ".npz"):
        os.replace(out + ".npz", out)
    return len(rec_sel)


def _cat_items(parts: list[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def read_trace_spacing(path: str) -> int:
    """Header max_complexity (tpa_parser.rs:38 read_trace_spacing)."""
    with np.load(path, allow_pickle=False) as z:
        return int(z["max_complexity"])


def _record_items(tp_type: str, spacing: int, qs: int, qe: int, ts: int,
                  te: int, rev: bool, kinds, a, b):
    """One record's segments from its tracepoint items, per item as
    impg_tpu's parse_tpa reads them: (dq, dt, diffs, literal_len,
    literal_op) as `_pair_segments` gives them."""
    advances: list[int] = []
    diffs: list[int] = []
    t_deltas: list[int] = []
    literal: list = []
    total_q = abs(qe - qs)
    q_used = 0  # running sum(advances): keeps this loop linear
    for i in range(len(kinds)):
        if int(kinds[i]) == KIND_CIGAR:
            op = int(a[i])
            ln = int(b[i])
            dq = ln if op != cigar.OP_D else 0
            dt = ln if op != cigar.OP_I else 0
            advances.append(dq)
            q_used += dq
            t_deltas.append(dt)
            diffs.append(0)
            literal.append([(ln, op)])
            continue
        ai, bi = int(a[i]), int(b[i])
        if tp_type == "standard":
            advances.append(ai)
            q_used += ai
            t_deltas.append(bi)
            diffs.append(0)
        elif tp_type in ("fastga", "fastga-nodiff"):
            # Fixed query spacing; pair = (diffs, target_delta)
            # (tpa_parser.rs:164; FastgaNoDiff drops the diff counts).
            # Grid anchored at absolute multiples of spacing: the first
            # segment is shorter (impg.rs:717 first_boundary).
            step = (
                _fastga_first_boundary(spacing, qs, qe, rev)
                if not advances else spacing
            )
            adv = min(step, max(total_q - q_used, 0))
            advances.append(adv)
            q_used += adv
            t_deltas.append(bi)
            diffs.append(ai if tp_type == "fastga" else 0)
        elif tp_type == "variable":
            # (target_delta, optional query_delta); absent second value
            # (-1) means the fixed spacing (tpa_parser.rs:180).
            t_deltas.append(ai)
            adv = (
                bi if bi >= 0
                else min(spacing, max(total_q - q_used, 0))
            )
            advances.append(adv)
            q_used += adv
            diffs.append(0)
        else:  # mixed pair item: (query_delta, target_delta)
            advances.append(ai)
            q_used += ai
            t_deltas.append(bi)
            diffs.append(0)
        literal.append(None)
    if not advances:
        advances = [abs(qe - qs)]
        t_deltas = [te - ts]
        diffs = [0]
        literal = [None]
    dt = np.asarray(t_deltas, np.int64)
    # The last bound is forced to te: the last segment takes the rest.
    dt[-1] = te - (ts + int(dt[:-1].sum()))
    return (np.asarray(advances, np.int64), dt, np.asarray(diffs, np.int64),
            np.asarray([0 if lt is None else lt[0][0] for lt in literal],
                       np.int64),
            np.asarray([-1 if lt is None else lt[0][1] for lt in literal],
                       np.int64))


def _pair_segments(tp_type: str, spacing: int, qs: int, qe: int, ts: int,
                   te: int, rev: bool, a: np.ndarray, b: np.ndarray):
    """`_record_items` for a record of pair items alone (no literal CIGAR
    item; not the variable encoding), with numpy: (dq, dt, diffs,
    literal_len, literal_op) as reconstruct_runs_batch takes them, the
    target bounds being ts + cumsum([0, *dt])."""
    n = len(a)
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    if n == 0:
        dq = np.asarray([abs(qe - qs)], np.int64)
        t = np.asarray([te - ts], np.int64)
        x = np.zeros(1, np.int64)
    elif tp_type in ("fastga", "fastga-nodiff"):
        # The walk's query position after item i is min(|qe - qs|,
        # first + i * spacing): each advance is capped by what is left.
        first = _fastga_first_boundary(spacing, qs, qe, rev)
        reach = np.minimum(
            abs(qe - qs), first + np.arange(n, dtype=np.int64) * spacing)
        dq = np.diff(reach, prepend=0)
        t = b
        x = a if tp_type == "fastga" else np.zeros(n, np.int64)
    else:  # standard, and mixed pairs: (query_delta, target_delta)
        dq, t, x = a, b, np.zeros(n, np.int64)
    dt = t.copy()
    # The last bound is forced to te: the last segment takes the rest.
    dt[-1] = te - (ts + int(t[:-1].sum()))
    zeros = np.zeros(dt.size, np.int64)
    return dq, dt, x, zeros, zeros - 1


def parse_tpa(path: str, seq_index: SequenceIndex, seq_fetch=None):
    """Parse a TPA container into PAF-shaped SoA columns.

    Mirrors TpaParser::parse_alignments + fetch_alignment: the name table
    pre-registers sequences, record metadata maps 1:1 onto rows, and each
    record's tracepoint items become per-segment (dq, dt, x) triples (or
    literal runs for Mixed CIGAR items) fed through the shared segment
    reconstruction (io/onealn.py reconstruct_runs).
    """
    from impg_tpu_torch.io.paf import PafRecords

    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"unsupported TPA container version in {path}")
        tp_type = str(z["tp_type"])
        spacing = int(z["max_complexity"])
        names = [str(n) for n in z["names"]]
        lengths = z["lengths"]
        id_map = [
            seq_index.get_or_insert_id(n, int(l))
            for n, l in zip(names, lengths)
        ]
        query_id = z["query_id"]
        target_id = z["target_id"]
        strand = z["strand"]
        q_start, q_end = z["q_start"], z["q_end"]
        t_start, t_end = z["t_start"], z["t_end"]
        tp_kind, tp_a, tp_b, tp_off = (
            z["tp_kind"], z["tp_a"], z["tp_b"], z["tp_off"],
        )
    if tp_type not in TP_TYPES:
        raise ValueError(f"unknown tp_type '{tp_type}' in {path}")

    n = len(query_id)
    runs_parts: list[np.ndarray] = []
    run_offsets = [0]
    # Without sequences, every record's segments are kept and their runs
    # built at once (reconstruct_runs_batch).
    seg_parts: list[tuple] = []
    for r in range(n):
        qid = id_map[int(query_id[r])]
        tid = id_map[int(target_id[r])]
        qs, qe = int(q_start[r]), int(q_end[r])
        ts, te = int(t_start[r]), int(t_end[r])
        rev = int(strand[r]) == 1
        lo, hi = int(tp_off[r]), int(tp_off[r + 1])
        kinds = tp_kind[lo:hi]
        a = tp_a[lo:hi]
        b = tp_b[lo:hi]
        if tp_type != "variable" and not (kinds == KIND_CIGAR).any():
            seg = _pair_segments(tp_type, spacing, qs, qe, ts, te, rev, a, b)
        else:
            seg = _record_items(tp_type, spacing, qs, qe, ts, te, rev,
                                kinds, a, b)
        if seq_fetch is None:
            seg_parts.append(seg)
            continue
        dq, dt, x, lit_len, lit_op = seg
        bounds = ts + np.concatenate([[0], np.cumsum(dt)])
        literal = [None if op < 0 else [(ln, op)]
                   for ln, op in zip(lit_len.tolist(), lit_op.tolist())]
        packed = reconstruct_runs(
            seq_index, qid, qs, qe, tid, rev,
            dq.tolist(), x.tolist(), bounds.tolist(), seq_fetch,
            literal_runs=literal,
        )
        runs_parts.append(packed)
        run_offsets.append(run_offsets[-1] + packed.size)
    if seq_fetch is None:
        cols = [
            np.concatenate([p[i] for p in seg_parts]) if seg_parts
            else np.zeros(0, np.int64)
            for i in range(5)
        ]
        runs, run_offsets = reconstruct_runs_batch(
            np.asarray([p[0].size for p in seg_parts], np.int64), *cols)
        runs_parts = [runs]

    return PafRecords(
        query_id=np.asarray([id_map[int(i)] for i in query_id], np.int32),
        q_start=q_start.astype(np.int32),
        q_end=q_end.astype(np.int32),
        target_id=np.asarray([id_map[int(i)] for i in target_id], np.int32),
        t_start=t_start.astype(np.int32),
        t_end=t_end.astype(np.int32),
        strand=strand.astype(np.int8),
        runs=(
            np.concatenate(runs_parts)
            if runs_parts
            else np.zeros(0, np.uint32)
        ),
        run_offsets=np.asarray(run_offsets, np.int64),
    ), spacing
