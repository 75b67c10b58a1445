"""An all-vs-all alignment set of yeast-like shape, drawn from the seed.

The draws are those of impg_tpu_torch/synth.py:realistic_directed_index
(bench.py's scale tier), copied here so that the benchmark's data stays as
it is whatever later changes make to synth.py.  The CIGAR shape and the
length mixture were fitted from the upstream impg's 7-strain yeast chrV
all-vs-all PAF: 18.4 runs per aligned kb (matches of 30-180 bp between 1-6
bp edits) and bimodal alignment lengths (a lognormal body with a median of
about 4.9 kb at 580 kb sequences, scaled to the sequence length, and a
share of near-full-length alignments).

`make` draws the alignments chunk by chunk and hands each chunk's columns to
the program's own ingest (`core.arena.build_directed`, then
`ImpgIndex._finalize`, the calls synth.py makes): that ingest is set-up.
The drawn columns are kept for the plain reference.
"""

from __future__ import annotations

import numpy as np

# The packed run format the program ingests: length in the low 29 bits,
# the op code above it (= X I D).
OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3
LEN_MASK = (1 << 29) - 1


def pack(lens: np.ndarray, ops: np.ndarray) -> np.ndarray:
    return (ops.astype(np.uint32) << 29) | (lens.astype(np.uint32) & LEN_MASK)


def seq_names(n_seqs: int) -> list[str]:
    return [f"g{i}#1#chr1" for i in range(n_seqs)]


def draw_chunks(seed: int, n_seqs: int, seq_len: int, n_aln: int,
                chunks: int, tail_frac: float, match_bp: tuple,
                edit_bp_max: int, edit_pairs_per_kb: float,
                body_median_at_580kb: float, body_sigma: float,
                max_aln_share: float, reverse_share: float):
    """Yields each chunk's alignments as a dict of columns (int32 ids and
    coordinates, int8 strand, packed uint32 runs and their int64 offsets)."""
    rng = np.random.default_rng(seed)
    match_lo, match_hi = match_bp
    body_median = max(300.0, seq_len * (body_median_at_580kb / 580_000.0))
    max_alen = int(seq_len * max_aln_share)
    per = (n_aln + chunks - 1) // chunks
    for ck in range(chunks):
        nk = min(per, n_aln - ck * per)
        if nk <= 0:
            break
        is_tail = rng.random(nk) < tail_frac
        alen = np.where(
            is_tail,
            rng.integers(int(seq_len * 0.67), max_alen + 1, nk),
            np.clip(rng.lognormal(np.log(body_median), body_sigma, nk),
                    150, max_alen).astype(np.int64),
        ).astype(np.int64)
        m = np.maximum(1, (alen * edit_pairs_per_kb / 1000.0)).astype(
            np.int64)
        n_runs = 2 * m + 1
        run_offsets = np.zeros(nk + 1, np.int64)
        np.cumsum(n_runs, out=run_offsets[1:])
        total = int(run_offsets[-1])
        pos_in_aln = np.arange(total, dtype=np.int64) - np.repeat(
            run_offsets[:-1], n_runs)
        is_match = (pos_in_aln & 1) == 0
        lens = np.where(
            is_match,
            rng.integers(match_lo, match_hi + 1, total),
            rng.integers(1, edit_bp_max + 1, total),
        ).astype(np.int64)
        draw = rng.integers(0, 4, total)
        ops = np.where(
            is_match, OP_EQ,
            np.where(draw < 2, OP_X, np.where(draw == 2, OP_I, OP_D)),
        ).astype(np.uint32)
        runs = pack(lens, ops)
        del pos_in_aln, draw
        tdelta = np.where(ops == OP_I, 0, lens)
        qdelta = np.where(ops == OP_D, 0, lens)
        t_len = np.add.reduceat(tdelta, run_offsets[:-1]).astype(np.int64)
        q_len = np.add.reduceat(qdelta, run_offsets[:-1]).astype(np.int64)
        del tdelta, qdelta, lens, ops, is_match
        target_id = rng.integers(0, n_seqs, nk).astype(np.int32)
        query_id = ((target_id + rng.integers(1, n_seqs, nk))
                    % n_seqs).astype(np.int32)
        t_start = rng.integers(0, np.maximum(seq_len - t_len, 1)).astype(
            np.int64)
        q_start = rng.integers(0, np.maximum(seq_len - q_len, 1)).astype(
            np.int64)
        strand = (rng.random(nk) < reverse_share).astype(np.int8)
        yield dict(
            query_id=query_id,
            q_start=q_start.astype(np.int32),
            q_end=(q_start + q_len).astype(np.int32),
            target_id=target_id,
            t_start=t_start.astype(np.int32),
            t_end=(t_start + t_len).astype(np.int32),
            strand=strand,
            runs=runs,
            run_offsets=run_offsets,
        )


def draw_params(config: dict) -> dict:
    keys = ("n_seqs", "seq_len", "n_aln", "chunks", "tail_frac", "match_bp",
            "edit_bp_max", "edit_pairs_per_kb", "body_median_at_580kb",
            "body_sigma", "max_aln_share", "reverse_share")
    p = {k: config[k] for k in keys}
    p["match_bp"] = tuple(p["match_bp"])
    return p


def make(config: dict, seed: int, workdir: str) -> dict:
    """The program's index over the drawn alignments, with the drawn
    columns, sequence names and lengths for the reference."""
    from impg_tpu_torch.core import arena as arena_mod
    from impg_tpu_torch.core.arena import CigarArena, DirectedRecords
    from impg_tpu_torch.core.seqidx import SequenceIndex
    from impg_tpu_torch.index.impg_index import ImpgIndex

    p = draw_params(config)
    chunks = []
    rec_parts = []
    arena_parts = {f: [] for f in CigarArena.EAGER_FIELDS}
    seg_parts = [np.zeros(1, np.int64)]
    arena_base = 0
    rec_base = 0
    for cols in draw_chunks(seed, **p):
        chunks.append(cols)
        records, arena = arena_mod.build_directed(**cols)
        records.op_off += arena_base
        records.rec_id += rec_base
        rec_parts.append(records)
        for f in arena_parts:
            arena_parts[f].append(getattr(arena, f))
        seg_parts.append(arena.seg_offsets[1:] + arena_base)
        arena_base += arena.n_ops
        rec_base += cols["query_id"].size
    records = DirectedRecords.concatenate(rec_parts)
    del rec_parts
    arena_cols = {f: np.concatenate(arena_parts.pop(f))
                  for f in list(arena_parts)}
    arena = CigarArena(**arena_cols, seg_offsets=np.concatenate(seg_parts))
    del arena_cols
    names = seq_names(p["n_seqs"])
    lengths = [p["seq_len"]] * p["n_seqs"]
    seq_index = SequenceIndex()
    for name, ln in zip(names, lengths):
        seq_index.get_or_insert_id(name, ln)
    index = ImpgIndex._finalize(seq_index, records, arena, [])
    return dict(index=index, chunks=chunks, names=names, lengths=lengths)
