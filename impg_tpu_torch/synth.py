"""Synthetic at-scale index for runs of the port on the card.

`realistic_directed_index` is the generator of tests/datagen.py of the same
name, kept here so that a run of the port (chip_smoke.py) imports only
impg_tpu_torch; tests/test_torch_synth.py holds the two equal.  It builds the
index through impg_tpu's numpy index modules (core/, index/), which import no
JAX.
"""

from __future__ import annotations

import numpy as np

from impg_tpu.core import arena as arena_mod
from impg_tpu.core import cigar
from impg_tpu.core.arena import CigarArena, DirectedRecords
from impg_tpu.core.seqidx import SequenceIndex
from impg_tpu.index.impg_index import ImpgIndex


def realistic_directed_index(
    seed: int = 3,
    n_seqs: int = 2000,
    seq_len: int = 150_000,
    n_aln: int = 2_500_000,
    chunks: int = 20,
    tail_frac: float = 0.2,
) -> ImpgIndex:
    """At-scale index with a yeast-fitted CIGAR-shape mixture.

    Fitted from a 7-strain yeast chrV all-vs-all PAF: 18.4 runs per kb
    aligned (matches of 30-180 bp alternating with 1-6 bp edits), and
    bimodal alignment lengths (a lognormal body with a median of ~4.9 kb at
    580 kb sequences, scaled to `seq_len`, and a `tail_frac` share of
    near-full-length alignments).  Records carry hundreds to thousands of
    runs, the shape of real pangenome PAFs.  Generation is chunked so
    temporaries stay ~1 GiB; the result is one bidirectional index (2x
    directed records)."""
    rng = np.random.default_rng(seed)
    match_lo, match_hi = 30, 180      # mean 105 bp
    edit_hi = 6                       # mean 3.5 bp
    edit_pairs_per_kb = 9.2           # -> 18.4 runs/kb aligned
    body_median = max(300.0, seq_len * (4900.0 / 580_000.0))
    body_sigma = 1.6
    max_alen = int(seq_len * 0.98)

    rec_parts: list[DirectedRecords] = []
    arena_parts: dict[str, list[np.ndarray]] = {
        f: [] for f in CigarArena.EAGER_FIELDS
    }
    seg_parts: list[np.ndarray] = [np.zeros(1, np.int64)]
    arena_base = 0
    rec_base = 0

    per = (n_aln + chunks - 1) // chunks
    for ck in range(chunks):
        nk = min(per, n_aln - ck * per)
        if nk <= 0:
            break
        # Alignment-length mixture.
        is_tail = rng.random(nk) < tail_frac
        alen = np.where(
            is_tail,
            rng.integers(int(seq_len * 0.67), max_alen + 1, nk),
            np.clip(
                rng.lognormal(np.log(body_median), body_sigma, nk),
                150, max_alen,
            ).astype(np.int64),
        ).astype(np.int64)
        m = np.maximum(1, (alen * edit_pairs_per_kb / 1000.0)).astype(
            np.int64
        )
        n_runs = 2 * m + 1
        run_offsets = np.zeros(nk + 1, np.int64)
        np.cumsum(n_runs, out=run_offsets[1:])
        total = int(run_offsets[-1])

        pos_in_aln = np.arange(total, dtype=np.int64) - np.repeat(
            run_offsets[:-1], n_runs
        )
        is_match = (pos_in_aln & 1) == 0
        lens = np.where(
            is_match,
            rng.integers(match_lo, match_hi + 1, total),
            rng.integers(1, edit_hi + 1, total),
        ).astype(np.int64)
        draw = rng.integers(0, 4, total)
        ops = np.where(
            is_match,
            cigar.OP_EQ,
            np.where(draw < 2, cigar.OP_X,
                     np.where(draw == 2, cigar.OP_I, cigar.OP_D)),
        ).astype(np.uint32)
        runs = cigar.pack(lens, ops)
        del pos_in_aln, draw

        tdelta = np.where(ops == cigar.OP_I, 0, lens)
        qdelta = np.where(ops == cigar.OP_D, 0, lens)
        t_len = np.add.reduceat(tdelta, run_offsets[:-1]).astype(np.int64)
        q_len = np.add.reduceat(qdelta, run_offsets[:-1]).astype(np.int64)
        del tdelta, qdelta, lens, ops, is_match

        target_id = rng.integers(0, n_seqs, nk).astype(np.int32)
        query_id = (
            (target_id + rng.integers(1, n_seqs, nk)) % n_seqs
        ).astype(np.int32)
        t_start = rng.integers(
            0, np.maximum(seq_len - t_len, 1)
        ).astype(np.int64)
        q_start = rng.integers(
            0, np.maximum(seq_len - q_len, 1)
        ).astype(np.int64)
        strand = (rng.random(nk) < 0.3).astype(np.int8)

        records, arena = arena_mod.build_directed(
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
        records.op_off += arena_base
        records.rec_id += rec_base
        rec_parts.append(records)
        for f in arena_parts:
            arena_parts[f].append(getattr(arena, f))
        seg_parts.append(arena.seg_offsets[1:] + arena_base)
        arena_base += arena.n_ops
        rec_base += nk

    records = DirectedRecords.concatenate(rec_parts)
    del rec_parts
    cols = {}
    for f in list(arena_parts):
        cols[f] = np.concatenate(arena_parts.pop(f))
    arena = CigarArena(**cols, seg_offsets=np.concatenate(seg_parts))
    del cols, seg_parts

    seq_index = SequenceIndex()
    for i in range(n_seqs):
        seq_index.get_or_insert_id(f"g{i}#1#chr1", seq_len)
    return ImpgIndex._finalize(seq_index, records, arena, [])
