"""Vectorized passes of the `sort` pipeline on GfaColumns.

The port's copy of impg_tpu/graph/columnar_ops.py's functions that `sort`
calls: `groom_columns` ('g'), `reorder_segments_columns` ('Y''s effect),
`topo_priority_columns` ('s'), `write_columns` with `_token_stream`, and
the spelling helpers `path_spellings` / `_spell_flat`.  The blob rewrites,
the topological sort and the text assembly run through the port's copies of
native/spellc.cpp and gfa_parser.cpp (io/native.py), with no Python
fallback: the sort path needs the native library, as its tokenizer does.
The spelling validation of crush, selfloops and normalize
(`validate_spellings`, `path_spellings_of_text`, `validate_text_spellings`)
and crush's link regeneration (`links_from_paths`) are copies too; the
text-level helpers return None without the native tokenizer, as impg_tpu's
do, and their callers fall back to the dict model.
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.graph.gfa_columns import GfaColumns


def spell_paths(gc: GfaColumns) -> list[bytes]:
    """Full spelling of every path (reverse steps reverse-complemented):
    one single-pass native kernel (native/spellc.cpp, threaded)."""
    out, path_bp = _spell_flat(gc)
    return [
        out[int(path_bp[p]) : int(path_bp[p + 1])].tobytes()
        for p in range(gc.n_paths)
    ]


def path_spellings(gc: GfaColumns) -> dict[str, bytes]:
    return dict(zip(gc.path_names, spell_paths(gc)))


def _spell_flat(gc: GfaColumns):
    """(out u8 view, per-path bp offsets). `out` may alias the native
    scratch buffer — invalidated by the next spelling call."""
    rows = gc.seg_row_of_name()[gc.step_name_idx]
    if rows.size and int(rows.min()) < 0:
        bad = int(gc.step_name_idx[int(np.argmin(rows))])
        raise ValueError(
            f"path step references missing segment '{gc.names[bad]}'"
        )
    lens = gc.seg_lens()[rows].astype(np.int64)
    bp_off = np.concatenate([[0], np.cumsum(lens)])
    from impg_tpu_torch.io import native as native_mod

    out = native_mod.spell_steps(
        gc.seq_blob, gc.seq_offsets, rows, gc.step_rev, bp_off
    )
    return out, bp_off[gc.path_off]


def validate_spellings(gc: GfaColumns, expected: dict[str, bytes]) -> bool:
    """True when every path spells exactly its `expected` bytes —
    zero-copy comparison against the flat spelled buffer (the crush /
    selfloops / normalize per-round validation contract)."""
    if gc.n_paths != len(expected):
        return False
    out, path_bp = _spell_flat(gc)
    # Per-path comparison, deliberately: path-sized tobytes() copies stay
    # cache-resident and bytes == bytes is one memcmp, where one flat
    # join would fault in fresh multi-MB buffers and a memoryview slice
    # compare has no memcmp fast path.
    for p, name in enumerate(gc.path_names):
        want = expected.get(name)
        if want is None:
            return False
        lo, hi = int(path_bp[p]), int(path_bp[p + 1])
        if hi - lo != len(want):
            return False
        if out[lo:hi].tobytes() != want:
            return False
    return True


def path_spellings_of_text(text: str) -> dict[str, bytes] | None:
    """Columnar spellings straight from GFA text; None when the native
    tokenizer is unavailable (callers fall back to the dict model)."""
    try:
        from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

        gc = parse_gfa_columns(text)
    except ValueError:
        raise
    except Exception:
        return None
    return path_spellings(gc)


def validate_text_spellings(text: str, expected: dict[str, bytes]):
    """Columnar spelling validation straight from GFA text; None when the
    native tokenizer is unavailable (callers fall back to dict spelling).
    """
    try:
        from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

        gc = parse_gfa_columns(text)
    except ValueError:
        raise
    except Exception:
        return None
    return validate_spellings(gc, expected)


def links_from_paths(gc: GfaColumns) -> np.ndarray:
    """Unique (a_idx, a_rev, b_idx, b_rev) adjacencies over all path
    steps, packed per row into uint64 (name idx < 2^31), sorted."""
    n_steps = gc.step_name_idx.size
    if n_steps == 0:
        return np.zeros(0, np.uint64)
    keep = np.ones(n_steps, bool)
    keep[gc.path_off[1:] - 1] = False  # last step of each path
    keep[-1] = False
    # uint64 packing: bit 63..33 = a (31 bits), 32 = ar, 31..1 = b, 0 = br.
    # int64 would flip sign at a >= 2^30 and corrupt the arithmetic-shift
    # unpack, so the whole pack/unpack path stays unsigned.
    a = gc.step_name_idx[:-1][keep[:-1]].astype(np.uint64)
    ar = gc.step_rev[:-1][keep[:-1]].astype(np.uint64)
    b = gc.step_name_idx[1:][keep[:-1]].astype(np.uint64)
    br = gc.step_rev[1:][keep[:-1]].astype(np.uint64)
    packed = (
        (a << np.uint64(33)) | (ar << np.uint64(32))
        | (b << np.uint64(1)) | br
    )
    return np.unique(packed)


def groom_columns(gc: GfaColumns) -> GfaColumns:
    """gfasort 'g' on columns: flip majority-reverse segments (spelling
    preserved — flipped segments store their RC, and every touching
    step/link orientation inverts). Blob rewrite reuses the native spell
    kernel (one pass)."""
    from dataclasses import replace

    from impg_tpu_torch.io import native as native_mod

    rows = gc.seg_row_of_name()
    step_rows = rows[gc.step_name_idx]
    n = gc.n_segs
    rev_votes = np.bincount(
        step_rows[gc.step_rev & (step_rows >= 0)], minlength=n
    )
    fwd_votes = np.bincount(
        step_rows[(~gc.step_rev) & (step_rows >= 0)], minlength=n
    )
    flip = rev_votes > fwd_votes
    if not flip.any():
        return gc
    seg_order = np.arange(n, dtype=np.int32)
    out = native_mod.spell_steps(
        gc.seq_blob, gc.seq_offsets, seg_order, flip.astype(np.uint8),
        gc.seq_offsets.astype(np.int64), reuse=False,
    )
    flip_of_name = np.zeros(len(gc.names), bool)
    flip_of_name[gc.seg_name_idx[flip]] = True
    return replace(
        gc,
        seq_blob=out.tobytes(),
        step_rev=gc.step_rev ^ flip_of_name[gc.step_name_idx],
        link_a_rev=gc.link_a_rev ^ flip_of_name[gc.link_a],
        link_b_rev=gc.link_b_rev ^ flip_of_name[gc.link_b],
        _seg_row_of_name=gc._seg_row_of_name,
    )


def reorder_segments_columns(gc: GfaColumns,
                             order: np.ndarray) -> GfaColumns:
    """Reorder segment ROWS (names unchanged) — the 'Y' stage's effect of
    resorting the segment dict by SGD rank."""
    from dataclasses import replace

    from impg_tpu_torch.io import native as native_mod

    order = np.asarray(order, np.int32)
    lens = gc.seg_lens()
    new_off = np.concatenate([[0], np.cumsum(lens[order])]).astype(np.int64)
    blob = native_mod.spell_steps(
        gc.seq_blob, gc.seq_offsets, order,
        np.zeros(order.size, np.uint8), new_off, reuse=False,
    )
    return replace(
        gc,
        seg_name_idx=gc.seg_name_idx[order],
        seq_blob=blob.tobytes(),
        seq_offsets=new_off,
        _seg_row_of_name=None,
    )


def topo_priority_columns(gc: GfaColumns) -> GfaColumns:
    """gfasort 's' on columns: stable priority topological sort (ties
    follow the current segment order) + 1..N renumbering. Links/steps
    referencing missing segments are dropped, like the dict model."""
    from dataclasses import replace

    from impg_tpu_torch.io import native as native_mod

    n = gc.n_segs
    rows = gc.seg_row_of_name()
    ea = rows[gc.link_a].astype(np.int32)
    eb = rows[gc.link_b].astype(np.int32)
    edge_ok = (ea >= 0) & (eb >= 0)
    prio = np.arange(n, dtype=np.int32)
    order = native_mod.topo_priority(n, ea[edge_ok], eb[edge_ok], prio)
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n)

    # Renumbered name table: segment rows become "1".."N"; names without a
    # segment row keep a slot but their links/steps are dropped below.
    new_names = [""] * len(gc.names)
    seg_new_names = [str(i + 1) for i in range(n)]
    for name_idx, row in enumerate(rows):
        new_names[name_idx] = (
            seg_new_names[int(rank[row])] if row >= 0 else gc.names[name_idx]
        )

    # Reorder the blob in one native pass (each segment = one fwd step).
    lens = gc.seg_lens()
    new_lens = lens[order]
    new_off = np.concatenate([[0], np.cumsum(new_lens)]).astype(np.int64)
    blob = native_mod.spell_steps(
        gc.seq_blob, gc.seq_offsets, order.astype(np.int32),
        np.zeros(n, np.uint8), new_off, reuse=False,
    )

    # New seg_name_idx: row k (rank order) -> name idx of the OLD segment
    # occupying that rank, which now carries the new name.
    seg_name_idx = gc.seg_name_idx[order]

    keep_link = edge_ok
    step_rows = rows[gc.step_name_idx]
    keep_step = step_rows >= 0
    if bool(keep_step.all()):
        step_name_idx = gc.step_name_idx
        step_rev = gc.step_rev
        path_off = gc.path_off
    else:
        # Drop steps on missing segments; recompute path offsets.
        step_name_idx = gc.step_name_idx[keep_step]
        step_rev = gc.step_rev[keep_step]
        kept_cum = np.concatenate(
            [[0], np.cumsum(keep_step.astype(np.int64))]
        )
        path_off = kept_cum[gc.path_off]
    return replace(
        gc,
        names=new_names,
        seg_name_idx=seg_name_idx,
        seq_blob=blob.tobytes(),
        seq_offsets=new_off,
        link_a=gc.link_a[keep_link],
        link_a_rev=gc.link_a_rev[keep_link],
        link_b=gc.link_b[keep_link],
        link_b_rev=gc.link_b_rev[keep_link],
        path_off=path_off,
        step_name_idx=step_name_idx,
        step_rev=step_rev,
        _seg_row_of_name=None,
    )


def _token_stream(tok_blob: bytes, tok_start: np.ndarray,
                  tok_len: np.ndarray, rows: np.ndarray):
    """Concatenate token table entries selected by `rows` — text bodies
    assembled with a single-pass native kernel. Tokens are (start, len)
    slices of `tok_blob` and may overlap."""
    from impg_tpu_torch.io import native as native_mod

    return native_mod.concat_tokens(tok_blob, tok_start, tok_len, rows)


def write_columns(gc: GfaColumns) -> str:
    """GFA text from columns, byte-identical to impg_tpu's dict-model
    `Gfa.write` (same line order and formats, incl. W lines). P bodies
    and L lines assemble through the native token-stream kernel over a
    shared-overlap token blob (one chunk `<NAME+,>NAME-,` per name
    serves all five token kinds as overlapping slices)."""
    from impg_tpu_torch.graph.gfa import _split_walk_name

    names = gc.names
    offs = gc.seq_offsets
    out_parts: list[bytes] = [gc.header.encode(), b"\n"]
    name_b = [n.encode() for n in names]

    # Shared-overlap token blob: chunk per name = "<" n "+," ">" n "-,".
    # Slices: <name @0, name+, @1, plain name @1, >name @len+3,
    # name-, @len+4 (reusing the trailing "-,"). Constants appended,
    # then the raw sequence blob so S lines stream through the same
    # kernel (one token per segment body).
    n_names = len(names)
    name_len = np.fromiter((len(b) for b in name_b), np.int64, n_names)
    chunk_len = 2 * name_len + 6
    chunk_off = np.concatenate([[0], np.cumsum(chunk_len)])
    tok_blob = (
        b"".join([b"<" + nb + b"+,>" + nb + b"-," for nb in name_b])
        + b"L\t\t+\t\t-\t\t+\t0M\n\t-\t0M\nS\t\n"
        + bytes(gc.seq_blob)
    )
    cbase = int(chunk_off[-1])
    seq_base = cbase + 23
    # Token ids: [0,n) name+, ; [n,2n) name-, ; [2n,3n) <name ;
    # [3n,4n) >name ; [4n,5n) plain name ; constants; then one token
    # per segment row (its sequence slice).
    soffs = offs.astype(np.int64)
    tok_start = np.concatenate([
        chunk_off[:-1] + 1,                     # name+,
        chunk_off[:-1] + name_len + 4,          # name-,
        chunk_off[:-1],                         # <name
        chunk_off[:-1] + name_len + 3,          # >name
        chunk_off[:-1] + 1,                     # plain name
        np.asarray([cbase, cbase + 2, cbase + 5, cbase + 8, cbase + 14,
                    cbase + 20, cbase + 21, cbase + 22], np.int64),
        seq_base + soffs[:-1],                  # segment sequences
    ])
    tok_len = np.concatenate([
        name_len + 2, name_len + 2, name_len + 1, name_len + 1, name_len,
        np.asarray([2, 3, 3, 6, 6, 2, 1, 1], np.int64),
        np.diff(soffs),
    ])
    C_L, C_SAP, C_SAM, C_SBP, C_SBM = (
        5 * n_names, 5 * n_names + 1, 5 * n_names + 2,
        5 * n_names + 3, 5 * n_names + 4,
    )
    C_S, C_NL = 5 * n_names + 5, 5 * n_names + 7
    SEQ0 = 5 * n_names + 8

    # S lines: 5 tokens per segment in one stream ("S\t" name "\t" seq
    # "\n"; the name+, token minus its trailing ",+" is "name\t"-shaped
    # only by luck — use plain name + the shared tab constant instead).
    if gc.n_segs:
        srows5 = np.empty((gc.n_segs, 5), np.int64)
        srows5[:, 0] = C_S
        srows5[:, 1] = 4 * n_names + gc.seg_name_idx.astype(np.int64)
        srows5[:, 2] = 5 * n_names + 6  # "\t"
        srows5[:, 3] = SEQ0 + np.arange(gc.n_segs, dtype=np.int64)
        srows5[:, 4] = C_NL
        s_bytes, _ = _token_stream(tok_blob, tok_start, tok_len,
                                   srows5.ravel())
        out_parts.append(s_bytes.tobytes())

    # L lines: 5 tokens per link in one stream.
    if gc.link_a.size:
        lrows = np.empty((gc.link_a.size, 5), np.int64)
        lrows[:, 0] = C_L
        lrows[:, 1] = 4 * n_names + gc.link_a
        lrows[:, 2] = np.where(gc.link_a_rev, C_SAM, C_SAP)
        lrows[:, 3] = 4 * n_names + gc.link_b
        lrows[:, 4] = np.where(gc.link_b_rev, C_SBM, C_SBP)
        l_bytes, _ = _token_stream(tok_blob, tok_start, tok_len,
                                   lrows.ravel())
        out_parts.append(l_bytes.tobytes())

    # P/W lines: step bodies for ALL paths in one token stream, then cut.
    body = b""
    path_bp = np.zeros(gc.path_off.size, np.int64)
    if gc.step_name_idx.size:
        walk_of_step = np.repeat(
            gc.path_is_walk.astype(bool),
            np.diff(gc.path_off).astype(np.int64),
        )
        sidx = gc.step_name_idx.astype(np.int64)
        srev = gc.step_rev
        srows = np.where(
            walk_of_step,
            np.where(srev, 2 * n_names + sidx, 3 * n_names + sidx),
            np.where(srev, n_names + sidx, sidx),
        )
        body_arr, body_off = _token_stream(
            tok_blob, tok_start, tok_len, srows
        )
        body = body_arr.tobytes()
        path_bp = body_off[gc.path_off]
    for p in range(gc.n_paths):
        lo, hi = int(gc.path_off[p]), int(gc.path_off[p + 1])
        name = gc.path_names[p]
        seg = body[int(path_bp[p]) : int(path_bp[p + 1])] if lo < hi else b""
        if bool(gc.path_is_walk[p]):
            parsed = _split_walk_name(name)
            if parsed is not None:
                sample, hap, seq, start, end = parsed
                out_parts.append(
                    f"W\t{sample}\t{hap}\t{seq}\t{start}\t{end}\t".encode()
                    + seg + b"\n"
                )
                continue
            # Walk name that no longer parses falls back to a P line:
            # regenerate this path's body with comma tokens.
            prows = np.where(
                gc.step_rev[lo:hi],
                n_names + gc.step_name_idx[lo:hi].astype(np.int64),
                gc.step_name_idx[lo:hi].astype(np.int64),
            )
            seg_p, _ = _token_stream(tok_blob, tok_start, tok_len, prows)
            out_parts.append(
                b"P\t" + name.encode() + b"\t" + seg_p.tobytes()[:-1]
                + b"\t*\n"
            )
            continue
        out_parts.append(
            b"P\t" + name.encode() + b"\t" + seg[:-1] + b"\t*\n"
        )
    return b"".join(out_parts).decode()
