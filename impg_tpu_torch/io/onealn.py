"""1aln (ONEcode) tracepoint alignments: ASCII + binary reader/writer.

Record lines mirror what the reference's onealn.rs consumes (onealn.rs:551
parse_single_alignment): `A qid qs qe tid ts te` coordinates, `R` for
reverse strand (target coords stored in the flipped frame, onealn.rs:654),
`T`/`X` integer lists (count-prefixed like ONEcode ASCII lists), `D` total
differences, and a `t <spacing>` header (onealn.rs:54).  T/X follow the
reference's FASTGA axis convention (impg.rs:714-746): T[i] is the TARGET
bp consumed across query-grid segment i, where the query grid's first
interior boundary is the next absolute multiple of trace_spacing after
q_start and subsequent boundaries step by trace_spacing; X[i] is the edit
bp in that segment.  The binary form uses the
ONEcode-structured container in `io/onecode.py` (ASCII header + embedded
schema, varint line stream, footer object index) giving O(1) per-record
seek like the reference's `file.goto('A', i+1)` fetch path
(onealn.rs:93-101); `OneAlnReader` below exposes that fetch API.
Sequence metadata is an embedded name table of `N <id> <length> <name>`
lines (the role of the reference's embedded GDB skeleton groups;
external .1gdb skeleton resolution, onealn.rs:230-320, does not apply to
self-contained exports).

Ingest reconstructs CIGAR runs per trace segment:
  - without sequences: a valid approximate CIGAR per segment —
    min(dq,dt)-x matches, x mismatches, |dq-dt| indel — exact interval
    endpoints, approximate interior (the reference's fast-mode contract,
    notes/FAST_MODE_IMPLEMENTATION.md);
  - with sequences: the native Gotoh aligner rebuilds each segment's exact
    runs (the tracepoints_to_cigar_with_aligner role, impg.rs:873).

The port's copy of impg_tpu/io/onealn.py (tests/test_torch_onealn.py holds
the two equal: files by bytes, parsed columns exactly).  Without sequences,
`parse_1aln` builds every record's runs at once with numpy
(`reconstruct_runs_batch`), which gives `reconstruct_runs`' runs.
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.io import onecode

ONEALN_SUFFIX = ".1aln"

# Embedded schema for the binary container (io/onecode.py); field layout
# matches the ASCII line grammar above.
ALN_SCHEMA = {
    "t": (onecode.T_INT,),
    "N": (onecode.T_INT, onecode.T_INT, onecode.T_STRING),
    "A": (onecode.T_INT,) * 6,
    "R": (),
    "T": (onecode.T_INT_LIST,),
    "X": (onecode.T_INT_LIST,),
    "D": (onecode.T_INT,),
}


def query_grid_bounds(qs: int, qe: int, spacing: int) -> np.ndarray:
    """Absolute query-axis segment boundaries for the FASTGA convention.

    First interior boundary is the next absolute multiple of `spacing`
    after qs (impg.rs:717 first_boundary = ((qs/ts)+1)*ts - qs, expressed
    there as a delta); boundaries then step by `spacing` up to qe.
    """
    fb = ((qs // spacing) + 1) * spacing
    if fb >= qe:
        return np.asarray([qs, qe], np.int64)
    interior = np.arange(fb, qe, spacing, dtype=np.int64)
    return np.concatenate([[qs], interior, [qe]])


def _fastga_lists(runs: np.ndarray, qs: int, qe: int, spacing: int,
                  rev: bool):
    """(T, X, D) for one record: T[i] = target bp per query-grid segment,
    X[i] = edit bp per segment, both in query-ascending (file) order;
    D = total edit bp. Matches the reference's FASTGA consumption
    (impg.rs:714-746: T values are TARGET deltas on a fixed-query-spacing
    grid anchored at absolute multiples of trace_spacing)."""
    lens = (runs & np.uint32(cigar.LEN_MASK)).astype(np.int64)
    kind = (runs >> np.uint32(29)).astype(np.int64)
    dq = np.where(kind != cigar.OP_D, lens, 0)
    dt = np.where(kind != cigar.OP_I, lens, 0)
    dx = np.where(
        (kind == cigar.OP_X) | (kind == cigar.OP_I) | (kind == cigar.OP_D),
        lens, 0,
    )
    cq = np.concatenate([[0], np.cumsum(dq)])
    ct = np.concatenate([[0], np.cumsum(dt)])
    cx = np.concatenate([[0], np.cumsum(dx)])

    bounds = query_grid_bounds(qs, qe, spacing)
    # Walk progress of each boundary: forward strand walks qs->qe, reverse
    # walks qe->qs (original-frame run order), so progress = b-qs or qe-b.
    p = (bounds - qs) if not rev else (qe - bounds)
    j = np.clip(np.searchsorted(cq[:-1], p, side="right") - 1, 0, None)
    frac = p - cq[j]
    kj = kind[j] if kind.size else np.zeros_like(j)
    t_adv = np.where(kj != cigar.OP_I, frac, 0) if kind.size else frac * 0
    x_adv = (
        np.where((kj == cigar.OP_X) | (kj == cigar.OP_I), frac, 0)
        if kind.size else frac * 0
    )
    tvals = ct[j] + t_adv
    xvals = cx[j] + x_adv
    # Leading/trailing deletion runs advance the target (and edit count)
    # at zero query progress, which the cq searchsorted walk cannot see:
    # pin the walk-start boundary (p == 0) to the alignment start and the
    # walk-end boundary (p == qe-qs) to the cumulative totals so that
    # sum(T) == target span and the X totals include terminal deletions.
    full = qe - qs
    tvals = np.where(p == 0, 0, np.where(p == full, ct[-1], tvals))
    xvals = np.where(p == 0, 0, np.where(p == full, cx[-1], xvals))
    T = np.abs(np.diff(tvals))
    X = np.abs(np.diff(xvals))
    return (
        [int(x) for x in T],
        [int(x) for x in X],
        int(cx[-1]) if kind.size else 0,
    )


def _emit_lines(seq_index: SequenceIndex, records, arena, spacing: int):
    """Yield the 1aln line stream as (linetype, fields) tuples."""
    yield "t", (spacing,)
    for i in range(len(seq_index)):
        yield "N", (i, seq_index.get_len_from_id(i), seq_index.get_name(i))
    for r in range(len(records)):
        if bool(records.is_reversed[r]):
            continue
        qid = int(records.query_id[r])
        tid = int(records.target_id[r])
        qs, qe = int(records.q_start[r]), int(records.q_end[r])
        ts, te = int(records.t_start[r]), int(records.t_end[r])
        rev = int(records.strand[r]) == 1
        if rev:
            tlen = seq_index.get_len_from_id(tid)
            ts_f, te_f = tlen - te, tlen - ts
        else:
            ts_f, te_f = ts, te
        off = int(records.op_off[r])
        cnt = int(records.op_cnt[r])
        T, X, D = _fastga_lists(
            arena.runs[off : off + cnt], qs, qe, spacing, rev
        )
        yield "A", (qid, qs, qe, tid, ts_f, te_f)
        if rev:
            yield "R", ()
        yield "T", (T,)
        yield "X", (X,)
        yield "D", (D,)


def write_1aln(
    path: str,
    seq_index: SequenceIndex,
    records,
    arena,
    tp,
    out_spacing: int | None = None,
    binary: bool = False,
) -> int:
    """Write the non-reversed directed records as 1aln using the
    tracepoint arena `tp` (TracepointArena over the same records).

    `binary=True` writes the ONEcode binary container ('A' lines
    footer-indexed for O(1) fetch); otherwise ASCII."""
    spacing = tp.spacing if out_spacing is None else out_spacing
    n_written = 0
    if binary:
        with onecode.OneBinaryWriter(
            path, "aln", 1, 1,
            schema=ALN_SCHEMA, indexed=("A",), provenance="impg_tpu",
        ) as w:
            for lt, fields in _emit_lines(seq_index, records, arena, spacing):
                w.write(lt, *fields)
                n_written += lt == "A"
        return n_written
    with open(path, "w") as fh:
        fh.write("1 3 aln 1 1\n")
        for lt, fields in _emit_lines(seq_index, records, arena, spacing):
            if lt in ("T", "X"):
                vals = fields[0]
                fh.write(
                    f"{lt} {len(vals)} "
                    + " ".join(str(int(x)) for x in vals)
                    + "\n"
                )
            elif lt == "R":
                fh.write("R\n")
            else:
                fh.write(lt + " " + " ".join(str(x) for x in fields) + "\n")
            n_written += lt == "A"
    return n_written


def _segment_runs_approx(dq: int, dt: int, x: int) -> list[tuple[int, int]]:
    """(length, op) runs for one trace segment without sequences."""
    aligned = min(dq, dt)
    x = min(x, aligned)
    out = []
    m = aligned - x
    if m > 0:
        out.append((m, cigar.OP_EQ))
    if x > 0:
        out.append((x, cigar.OP_X))
    if dq > dt:
        out.append((dq - dt, cigar.OP_I))
    elif dt > dq:
        out.append((dt - dq, cigar.OP_D))
    return out


def reconstruct_runs(
    seq_index: SequenceIndex,
    qid: int,
    qs: int,
    qe: int,
    tid: int,
    rev: bool,
    advances,
    diffs,
    bounds,
    seq_fetch=None,
    literal_runs=None,
) -> np.ndarray:
    """Packed CIGAR runs for one tracepoint record.

    Segments walk the FORWARD target frame `bounds[i]..bounds[i+1]` in
    alignment order; reverse-strand queries mirror down from `qe` and are
    reverse-complemented for exact realignment (the
    tracepoints_to_cigar_with_aligner role, impg.rs:873).  `literal_runs`
    may carry per-segment pre-resolved (length, op) runs (the TPA mixed
    encoding's CigarOp entries); such segments skip reconstruction.
    """
    seg_runs: list[tuple[int, int]] = []
    q_walk = 0
    exact_ok = seq_fetch is not None
    for i, (dq, x) in enumerate(zip(advances, diffs)):
        lit = literal_runs[i] if literal_runs is not None else None
        if lit is not None:
            seg_runs.extend(lit)
            q_walk += dq
            continue
        dt = bounds[i + 1] - bounds[i]
        if dt <= 0 and dq <= 0:
            continue
        if exact_ok and dq > 0 and dt > 0:
            t_sub = seq_fetch(
                seq_index.get_name(tid), bounds[i], bounds[i + 1]
            )
            if rev:
                q_hi = qe - q_walk
                q_sub = seq_fetch(seq_index.get_name(qid), q_hi - dq, q_hi)
                from impg_tpu_torch.io.fasta import reverse_complement

                q_sub = reverse_complement(q_sub)
            else:
                q_lo = qs + q_walk
                q_sub = seq_fetch(seq_index.get_name(qid), q_lo, q_lo + dq)
            from impg_tpu_torch.ops.align import align_pair

            packed = align_pair(q_sub, t_sub)
            seg_runs.extend(
                (int(l), int(o))
                for l, o in zip(cigar.run_len(packed), cigar.run_op(packed))
            )
        else:
            seg_runs.extend(_segment_runs_approx(dq, dt, x))
        q_walk += dq
    # Merge adjacent same-op runs.
    merged: list[tuple[int, int]] = []
    for ln, op in seg_runs:
        if merged and merged[-1][1] == op:
            merged[-1] = (merged[-1][0] + ln, op)
        else:
            merged.append((ln, op))
    return cigar.pack(
        np.asarray([l for l, _ in merged], np.int64),
        np.asarray([o for _, o in merged], np.uint32),
    )


def reconstruct_runs_batch(
    seg_counts: np.ndarray,
    dq: np.ndarray,
    dt: np.ndarray,
    diffs: np.ndarray,
    literal_len: np.ndarray | None = None,
    literal_op: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Packed runs of many records at once, without sequences.

    The records' trace segments are concatenated: record r owns
    `seg_counts[r]` consecutive entries of the per-segment query advance
    `dq`, target advance `dt` and edit count `diffs`.  A segment whose
    `literal_op` is >= 0 is one literal run (`literal_len`, `literal_op`),
    the TPA mixed encoding's CIGAR item.  Every record's runs are
    `reconstruct_runs(..., seq_fetch=None)`'s: each segment gives
    `_segment_runs_approx`'s runs (none when dq <= 0 and dt <= 0), and
    adjacent runs of one op merge within a record.  Returns (runs uint32,
    run_offsets int64 [n_records + 1]).
    """
    n_rec = len(seg_counts)
    dq = np.asarray(dq, np.int64)
    dt = np.asarray(dt, np.int64)
    diffs = np.asarray(diffs, np.int64)
    if literal_op is None:
        literal_len = np.zeros(dq.size, np.int64)
        literal_op = np.full(dq.size, -1, np.int64)
    is_lit = np.asarray(literal_op) >= 0
    approx = ~is_lit & ~((dt <= 0) & (dq <= 0))
    aligned = np.minimum(dq, dt)
    x = np.minimum(diffs, aligned)
    m = aligned - x
    # Up to four candidate runs a segment, in _segment_runs_approx's order
    # (=, X, the indel), then the literal run.
    lens = np.stack([m, x, np.abs(dq - dt),
                     np.asarray(literal_len, np.int64)], axis=1)
    ops = np.stack([
        np.full(dq.size, cigar.OP_EQ, np.int64),
        np.full(dq.size, cigar.OP_X, np.int64),
        np.where(dq > dt, cigar.OP_I, cigar.OP_D).astype(np.int64),
        np.asarray(literal_op, np.int64),
    ], axis=1)
    keep = np.stack([approx & (m > 0), approx & (x > 0),
                     approx & (dq != dt), is_lit], axis=1)
    rec = np.repeat(np.arange(n_rec, dtype=np.int64),
                    np.asarray(seg_counts, np.int64))
    lens = lens[keep]
    ops = ops[keep]
    rec = np.broadcast_to(rec[:, None], keep.shape)[keep]
    if lens.size == 0:
        return np.zeros(0, np.uint32), np.zeros(n_rec + 1, np.int64)
    # Merge adjacent same-op runs of one record.
    start = np.ones(lens.size, bool)
    start[1:] = (ops[1:] != ops[:-1]) | (rec[1:] != rec[:-1])
    first = np.flatnonzero(start)
    merged = np.add.reduceat(lens, first)
    runs = cigar.pack(merged, ops[first].astype(np.uint32))
    run_offsets = np.zeros(n_rec + 1, np.int64)
    np.cumsum(np.bincount(rec[first], minlength=n_rec), out=run_offsets[1:])
    return runs, run_offsets


def _record_segments(qs: int, qe: int, ts: int, te: int, rev: bool, t_list,
                     x_list, spacing: int):
    """(dq, dt, diffs) of one record's trace segments in walk order.

    FASTGA convention (impg.rs:714-746): T values are TARGET deltas per
    query-grid segment, the first boundary at the next absolute multiple
    of the spacing from qs, then every spacing bp.  A foreign spacing's
    advances are padded or truncated to the T list; reverse records'
    lists are reversed, since reconstruct_runs walks the forward target
    frame (query descending from qe); the last bound is forced to te.
    The target bounds are ts + cumsum([0, *dt])."""
    t = np.asarray(t_list or [], np.int64)
    n = t.size
    if n == 0:
        return (np.asarray([abs(qe - qs)], np.int64),
                np.asarray([te - ts], np.int64), np.zeros(1, np.int64))
    x = np.asarray(x_list or [], np.int64)
    if x.size < n:
        x = np.concatenate([x, np.zeros(n - x.size, np.int64)])
    adv = np.diff(query_grid_bounds(qs, qe, spacing))
    if adv.size < n:
        adv = np.concatenate([adv, np.zeros(n - adv.size, np.int64)])
    elif adv.size > n:
        adv = np.concatenate([adv[: n - 1], [adv[n - 1:].sum()]])
    if rev:
        t, adv, x = t[::-1], adv[::-1], x[::-1]
    dt = t.copy()
    # The last bound is forced to te: the last segment takes the rest.
    dt[-1] = te - (ts + int(t[:-1].sum()))
    return adv, dt, x[:n]


def parse_1aln(
    path: str,
    seq_index: SequenceIndex,
    seq_fetch=None,
):
    """Parse into PAF-shaped SoA columns (io/paf.py PafRecords layout).

    `seq_fetch(name, start, end) -> bytes` enables exact per-segment
    CIGAR reconstruction with the native aligner; without it, segments
    materialize approximate runs.
    """
    from impg_tpu_torch.io.paf import PafRecords

    spacing = 100
    name_of: dict[int, int] = {}  # file id -> seq_index id
    cols = dict(
        query_id=[], q_start=[], q_end=[],
        target_id=[], t_start=[], t_end=[], strand=[],
    )
    runs_parts: list[np.ndarray] = []
    run_offsets = [0]
    # Without sequences, every record's segments are kept and their runs
    # built at once (reconstruct_runs_batch).
    seg_parts: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    cur = None  # (qid, qs, qe, tid, ts, te)
    cur_rev = False
    cur_T: list[int] | None = None
    cur_X: list[int] | None = None

    def flush():
        nonlocal cur, cur_rev, cur_T, cur_X
        if cur is None:
            return
        qid_f, qs, qe, tid_f, ts, te = cur
        if qid_f not in name_of or tid_f not in name_of:
            raise ValueError(
                f"{path}: alignment references sequence id "
                f"{qid_f if qid_f not in name_of else tid_f} but the file "
                "carries no embedded name table ('N' lines). Upstream "
                ".1aln files resolve names through an external .1gdb "
                "skeleton (onealn.rs:230), which is not supported — "
                "convert the alignment set to PAF (ALNtoPAF) or re-export "
                "with `impg-tpu export-1aln`."
            )
        qid = name_of[qid_f]
        tid = name_of[tid_f]
        if cur_rev:
            tlen = seq_index.get_len_from_id(tid)
            ts, te = tlen - te, tlen - ts
        adv, dt, x = _record_segments(qs, qe, ts, te, cur_rev, cur_T,
                                      cur_X, spacing)
        if seq_fetch is None:
            seg_parts.append((adv, dt, x))
        else:
            bounds = ts + np.concatenate([[0], np.cumsum(dt)])
            packed = reconstruct_runs(
                seq_index, qid, qs, qe, tid, cur_rev,
                adv.tolist(), x.tolist(), bounds.tolist(), seq_fetch,
            )
            runs_parts.append(packed)
            run_offsets.append(run_offsets[-1] + packed.size)
        cols["query_id"].append(qid)
        cols["q_start"].append(qs)
        cols["q_end"].append(qe)
        cols["target_id"].append(tid)
        cols["t_start"].append(ts)
        cols["t_end"].append(te)
        cols["strand"].append(1 if cur_rev else 0)
        cur, cur_rev, cur_T, cur_X = None, False, None, None

    for tag, fields in iter_1aln_lines(path):
        if tag == "t":
            spacing = int(fields[0])
        elif tag == "N":
            fid, length, name = int(fields[0]), int(fields[1]), fields[2]
            name_of[fid] = seq_index.get_or_insert_id(name, length)
        elif tag == "A":
            flush()
            cur = tuple(int(x) for x in fields[:6])
        elif tag == "R":
            cur_rev = True
        elif tag == "T":
            cur_T = [int(x) for x in fields[0]]
        elif tag == "X":
            cur_X = [int(x) for x in fields[0]]
        # 'D' totals and unknown types are skipped (onealn.rs skips
        # unhandled associated lines too).
    flush()
    if seq_fetch is None:
        cat = lambda i: (  # noqa: E731
            np.concatenate([p[i] for p in seg_parts]) if seg_parts
            else np.zeros(0, np.int64))
        runs, offsets = reconstruct_runs_batch(
            np.asarray([p[0].size for p in seg_parts], np.int64),
            cat(0), cat(1), cat(2),
        )
        runs_parts, run_offsets = [runs], offsets

    return PafRecords(
        query_id=np.asarray(cols["query_id"], np.int32),
        q_start=np.asarray(cols["q_start"], np.int32),
        q_end=np.asarray(cols["q_end"], np.int32),
        target_id=np.asarray(cols["target_id"], np.int32),
        t_start=np.asarray(cols["t_start"], np.int32),
        t_end=np.asarray(cols["t_end"], np.int32),
        strand=np.asarray(cols["strand"], np.int8),
        runs=(
            np.concatenate(runs_parts)
            if runs_parts
            else np.zeros(0, np.uint32)
        ),
        run_offsets=np.asarray(run_offsets, np.int64),
    ), spacing


def iter_1aln_lines(path: str):
    """Yield (linetype, fields) from an ASCII or binary 1aln file.

    Binary files (io/onecode.py container) yield typed fields directly;
    ASCII lines are tokenized to the same shapes: T/X yield one int list,
    N yields (id, length, name), A yields six ints.
    """
    if onecode.is_onecode_binary(path):
        yield from onecode.OneBinaryReader(path)
        return
    # Upstream ONElib BINARY .1aln detection: an ASCII "1 3 aln" header
    # followed by binary payload bytes, without this framework's container
    # footer. Error with the conversion path instead of misparsing
    # (onealn.rs:50 reads these via the onecode crate; ONElib's binary
    # codec spec is not published in this environment).
    with open(path, "rb") as fh:
        head = fh.read(4096)
    if head[:1] == b"1" and any(b > 0x7E or b < 0x09 for b in head):
        # Header-first recognition (onecode.describe_onecode_header): the
        # ASCII header grammar is shared with ONElib, so describe the file
        # and the precise missing codec facts before erroring.
        desc = onecode.describe_onecode_summary(path)
        info = onecode.describe_onecode_header(path)
        gaps = "; ".join(info["missing"]) if info else ""
        raise ValueError(
            f"{path}: recognized {desc or 'an upstream ONElib binary file'}"
            f" — but its compressed line stream cannot be decoded here "
            f"(missing codec facts: {gaps}). Convert to ASCII with the "
            "ONEcode toolchain (`ONEview file.1aln > file.1aln.txt`) or "
            "re-export from this framework (`impg-tpu export-1aln "
            "--binary`)."
        )
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag in ("T", "X"):
                n = int(parts[1])
                yield tag, ([int(x) for x in parts[2 : 2 + n]],)
            elif tag == "N":
                yield tag, (
                    int(parts[1]),
                    int(parts[2]),
                    line.split(None, 3)[3].rstrip("\n"),
                )
            elif tag == "A":
                yield tag, tuple(int(x) for x in parts[1:7])
            elif tag == "R":
                yield tag, ()
            elif tag in ("t", "D"):
                yield tag, (int(parts[1]),)
            # header/unknown lines are not part of the record stream


class OneAlnReader:
    """O(1) per-alignment access to a binary 1aln container.

    The onealn.rs:80-155 fetch path: open once, ``goto('A', i)``, read
    the A line and its associated R/D/T/X lines.  ASCII files raise —
    O(1) seek needs the binary footer index (the reference's ASCII
    ONEcode files likewise lack the object index)."""

    def __init__(self, path: str):
        if not onecode.is_onecode_binary(path):
            raise ValueError(
                f"{path}: O(1) fetch needs the binary 1aln container"
            )
        self._reader = onecode.OneBinaryReader(path)
        self.n_alignments = len(self._reader.index.get("A", []))
        self.trace_spacing = 100
        for lt, fields in self._reader:
            if lt == "t":
                self.trace_spacing = int(fields[0])
                break
            if lt == "A":
                break

    def fetch_alignment(self, i: int) -> dict:
        """Fetch alignment `i` (0-based): coordinates in the file frame
        (reverse-strand targets flipped, onealn.rs:654), strand, T/X
        tracepoint lists, and total differences."""
        r = self._reader
        r.goto("A", i)
        lt, fields = r.read_line()
        out = {
            "query_id": fields[0],
            "q_start": fields[1],
            "q_end": fields[2],
            "target_id": fields[3],
            "t_start": fields[4],
            "t_end": fields[5],
            "strand": "+",
            "tracepoints": [],
            "diffs": [],
            "differences": 0,
        }
        while True:
            line = r.read_line()
            if line is None:
                break
            lt, fields = line
            if lt == "A":
                break
            if lt == "R":
                out["strand"] = "-"
            elif lt == "T":
                out["tracepoints"] = fields[0]
            elif lt == "X":
                out["diffs"] = fields[0]
            elif lt == "D":
                out["differences"] = int(fields[0])
        return out
