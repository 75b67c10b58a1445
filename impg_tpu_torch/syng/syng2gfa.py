"""Dump a SyngIndex as a GFA syncmer graph (reference:
commands/syng2gfa.rs — blunt mode: one segment per syncmer occurrence
class, one per inter-syncmer/terminal gap, exact source-spelling 0M
paths; high-frequency syncmers privatized per occurrence).

Blunt construction: each sequence cuts at its syncmer start positions; a
syncmer piece spans [p_i, min(p_i + syncmer_len, p_{i+1})) (truncated when
the next syncmer overlaps), gap/terminal pieces cover the rest.  Pieces
intern by (kind key, forward-frame sequence): shared syncmers collapse
across genomes only when they spell identical DNA, gap pieces additionally
carry their signed-syncmer context so unrelated repeats stay separate.
Reverse-strand occurrences store the canonical forward sequence and step
with '-'.  Path spellings reproduce the sources exactly.

The port's copy of impg_tpu/syng/syng2gfa.py (tests/test_torch_syng_tools.py
holds the two equal, GFA bytes included).
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.io.fasta import reverse_complement
from impg_tpu_torch.syng.index import SyngIndex

DEFAULT_DROP_TOP_FRACTION = 0.0005


def _split_n_runs(piece: bytes, min_run: int):
    """(pieces, starts_with_cut, ends_with_cut): split `piece` at N-runs of
    at least `min_run` (syng2gfa.rs push_gap_with_n_cutting: ambiguous gap
    DNA is dropped and the path BREAKS there; shorter N runs stay)."""
    import re

    spans = [
        m.span() for m in re.finditer(rb"[Nn]{%d,}" % min_run, piece)
    ]
    if not spans:
        return [piece], False, False
    pieces = []
    prev = 0
    for s, e in spans:
        if s > prev:
            pieces.append(piece[prev:s])
        prev = e
    if prev < len(piece):
        pieces.append(piece[prev:])
    return pieces, spans[0][0] == 0, spans[-1][1] == len(piece)


_BREAK = None  # path-break marker inside step lists


def _emit_path_parts(name: str, steps: list) -> list:
    """Split `steps` at _BREAK markers; emit one P line per non-empty part
    (named `name|partN` when split, syng2gfa.rs
    test_walked_path_segments_are_named_when_split)."""
    parts: list[list] = [[]]
    for st in steps:
        if st is _BREAK:
            if parts[-1]:
                parts.append([])
        else:
            parts[-1].append(st)
    parts = [p for p in parts if p]
    out = []
    for idx, part in enumerate(parts):
        pname = name if len(parts) == 1 else f"{name}|part{idx + 1}"
        out.append((pname, part))
    return out


def syng_to_gfa(
    syng: SyngIndex,
    seq_idx,
    drop_top_fraction: float = DEFAULT_DROP_TOP_FRACTION,
    max_occurrences: int | None = None,
    mode: str = "blunt",
    cut_n_gaps: bool = False,
    cut_n_min_run: int = 10,
) -> str:
    """GFA 1.0 text for the whole index; `seq_idx` provides source bases.

    `mode="raw"` emits the explicit syng-native OVERLAP graph
    (syng2gfa.rs:171 SyngGfaMode::Raw): every syncmer keeps its full
    k-length canonical segment shared across both orientations
    (RC-sharing), directly-adjacent syncmers link with
    `(k - offset)M` overlaps (syng2gfa.rs:815), and only
    beyond-k gaps materialize gap segments.  Blunt mode (default)
    truncates overlapping pieces so all links are 0M.
    """
    if mode == "raw":
        return _syng_to_gfa_raw(
            syng, seq_idx, drop_top_fraction, max_occurrences
        )
    k = syng.syncmer_len
    # Frequency mask: the most frequent ids become PRIVATE (one node per
    # occurrence) instead of shared glue (syng2gfa.rs frequency mask role).
    ids_all = syng.occ_ids
    uniq, counts = np.unique(ids_all, return_counts=True)
    private: set[int] = set()
    if uniq.size and drop_top_fraction > 0:
        n_drop = int(np.ceil(uniq.size * drop_top_fraction))
        if n_drop > 0:
            order = np.argsort(counts)
            for i in order[-n_drop:]:
                if counts[i] > 1:
                    private.add(int(uniq[i]))
    if max_occurrences is not None:
        for i in range(uniq.size):
            if counts[i] > max_occurrences:
                private.add(int(uniq[i]))

    segments: list[str] = []  # node id -> sequence (1-based ids)
    intern: dict[tuple, int] = {}

    def node_for(key: tuple, fwd_seq: bytes) -> int:
        nid = intern.get(key)
        if nid is None:
            segments.append(fwd_seq.decode())
            nid = len(segments)
            intern[key] = nid
        return nid

    paths: list[tuple[str, list[tuple[int, bool]]]] = []
    links: set[tuple[int, bool, int, bool]] = set()
    private_counter = 0

    for sid in range(len(syng.seq_index)):
        name = syng.seq_index.get_name(sid)
        L = syng.seq_index.get_len_from_id(sid)
        seq = seq_idx.fetch_sequence(name, 0, L)
        pos, ids, fwd = syng.region_syncmers(name, 0, L)
        order = np.argsort(pos)
        pos, ids, fwd = pos[order], ids[order], fwd[order]
        steps: list[tuple[int, bool]] = []
        signed = [
            (int(i) if bool(f) else -int(i)) for i, f in zip(ids, fwd)
        ]

        def add_gap(lo: int, hi: int, left_ctx, right_ctx):
            if hi <= lo:
                return
            piece = seq[lo:hi]
            if not cut_n_gaps:
                key = ("gap", left_ctx, right_ctx, piece)
                steps.append((node_for(key, piece), False))
                return
            pieces, starts_cut, ends_cut = _split_n_runs(
                piece, max(cut_n_min_run, 1)
            )
            if starts_cut:
                steps.append(_BREAK)
            for j, sub in enumerate(pieces):
                if j:
                    steps.append(_BREAK)
                key = ("gap", left_ctx, right_ctx, sub, j)
                steps.append((node_for(key, sub), False))
            if ends_cut:
                steps.append(_BREAK)

        prev_end = 0
        for i in range(pos.size):
            p = int(pos[i])
            nxt = int(pos[i + 1]) if i + 1 < pos.size else None
            end = min(p + k, nxt) if nxt is not None else p + k
            end = min(end, L)
            add_gap(
                prev_end, p,
                signed[i - 1] if i > 0 else None,
                signed[i],
            )
            piece = seq[p:end]
            rev = not bool(fwd[i])
            fwd_seq = reverse_complement(piece) if rev else piece
            sig = int(ids[i])
            if sig in private:
                private_counter += 1
                key = ("priv", private_counter)
            else:
                key = ("syn", sig, fwd_seq)
            steps.append((node_for(key, fwd_seq), rev))
            prev_end = end
        add_gap(
            prev_end, L, signed[-1] if signed else None, None
        )
        for pname, part in _emit_path_parts(name, steps):
            for a, b in zip(part, part[1:]):
                links.add((a[0], a[1], b[0], b[1]))
            paths.append((pname, part))

    lines = ["H\tVN:Z:1.0"]
    for i, s in enumerate(segments):
        lines.append(f"S\t{i + 1}\t{s}")
    for a, ar, b, br in sorted(links):
        lines.append(
            f"L\t{a}\t{'-' if ar else '+'}\t{b}\t{'-' if br else '+'}\t0M"
        )
    for name, steps in paths:
        walk = ",".join(
            f"{nid}{'-' if rev else '+'}" for nid, rev in steps
        )
        lines.append(f"P\t{name}\t{walk}\t*")
    return "\n".join(lines) + "\n"


def _private_ids(
    syng: SyngIndex, drop_top_fraction: float, max_occurrences: int | None
) -> set[int]:
    """Ids too frequent to act as shared glue (one node per occurrence)."""
    uniq, counts = np.unique(syng.occ_ids, return_counts=True)
    private: set[int] = set()
    if uniq.size and drop_top_fraction > 0:
        n_drop = int(np.ceil(uniq.size * drop_top_fraction))
        if n_drop > 0:
            order = np.argsort(counts)
            for i in order[-n_drop:]:
                if counts[i] > 1:
                    private.add(int(uniq[i]))
    if max_occurrences is not None:
        for i in range(uniq.size):
            if counts[i] > max_occurrences:
                private.add(int(uniq[i]))
    return private


def _syng_to_gfa_raw(
    syng: SyngIndex,
    seq_idx,
    drop_top_fraction: float,
    max_occurrences: int | None,
) -> str:
    k = syng.syncmer_len
    private = _private_ids(syng, drop_top_fraction, max_occurrences)
    segments: list[str] = []
    intern: dict[tuple, int] = {}

    def node_for(key: tuple, fwd_seq: bytes) -> int:
        nid = intern.get(key)
        if nid is None:
            segments.append(fwd_seq.decode())
            nid = len(segments)
            intern[key] = nid
        return nid

    paths: list[tuple[str, list[tuple[int, bool]]]] = []
    links: set[tuple[int, bool, int, bool, int]] = set()
    private_counter = 0

    for sid in range(len(syng.seq_index)):
        name = syng.seq_index.get_name(sid)
        L = syng.seq_index.get_len_from_id(sid)
        seq = seq_idx.fetch_sequence(name, 0, L)
        pos, ids, fwd = syng.region_syncmers(name, 0, L)
        order = np.argsort(pos)
        pos, ids, fwd = pos[order], ids[order], fwd[order]
        steps: list[tuple[int, bool]] = []
        step_overlaps: list[int] = []  # incoming overlap per step

        def add_gap(lo: int, hi: int) -> None:
            if hi <= lo:
                return
            piece = seq[lo:hi]
            steps.append((node_for(("gap", piece), piece), False))
            step_overlaps.append(0)

        prev_p = None
        for i in range(pos.size):
            p = int(pos[i])
            if prev_p is None:
                add_gap(0, p)
                incoming = 0
            else:
                offset = p - prev_p
                if offset < k:
                    incoming = k - offset  # direct adjacency overlap
                else:
                    add_gap(prev_p + k, p)
                    incoming = 0
            end = min(p + k, L)
            piece = seq[p:end]
            rev = not bool(fwd[i])
            fwd_seq = reverse_complement(piece) if rev else piece
            sig = int(ids[i])
            if sig in private:
                private_counter += 1
                key = ("priv", private_counter)
            else:
                key = ("syn", sig, fwd_seq)
            steps.append((node_for(key, fwd_seq), rev))
            step_overlaps.append(incoming)
            prev_p = p
        if prev_p is not None:
            add_gap(prev_p + k, L)
        else:
            add_gap(0, L)
        for (a, b), ov in zip(zip(steps, steps[1:]), step_overlaps[1:]):
            links.add((a[0], a[1], b[0], b[1], ov))
        paths.append((name, steps))

    lines = ["H\tVN:Z:1.0"]
    for i, s in enumerate(segments):
        lines.append(f"S\t{i + 1}\t{s}")
    for a, ar, b, br, ov in sorted(links):
        lines.append(
            f"L\t{a}\t{'-' if ar else '+'}\t{b}\t{'-' if br else '+'}\t{ov}M"
        )
    for name, steps in paths:
        walk = ",".join(
            f"{nid}{'-' if rev else '+'}" for nid, rev in steps
        )
        lines.append(f"P\t{name}\t{walk}\t*")
    return "\n".join(lines) + "\n"


def paths_to_walks(gfa_text: str, lengths: dict[str, int]) -> str:
    """Rewrite P lines as GFA 1.1 W lines (syng2gfa.rs --gfa-version 1.1).

    PanSN names (sample#hap#contig) map onto the W sample/hap/seq fields;
    other names use (name, 0, name).  The header advertises VN:Z:1.1.
    """
    out = []
    for line in gfa_text.splitlines():
        f = line.split("\t")
        if f[0] == "H":
            out.append("H\tVN:Z:1.1")
            continue
        if f[0] == "P" and len(f) >= 3:
            name = f[1]
            parts = name.split("#")
            if len(parts) == 3 and all(parts):
                sample, hap, seq = parts
            else:
                sample, hap, seq = name, "0", name
            walk = "".join(
                ("<" if s.endswith("-") else ">") + s[:-1]
                for s in f[2].split(",")
                if s
            )
            end = lengths.get(name, 0)
            out.append(f"W\t{sample}\t{hap}\t{seq}\t0\t{end}\t{walk}")
            continue
        out.append(line)
    return "\n".join(out) + "\n"
