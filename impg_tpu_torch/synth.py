"""Synthetic at-scale index for runs of the port on the card.

`realistic_directed_index` is the generator of tests/datagen.py of the same
name, kept here so that a run of the port (chip_smoke.py) imports only
impg_tpu_torch; tests/test_torch_synth.py holds the two equal.  It builds the
index through the port's own index modules (core/, index/).

`haplotype_panel` and `sample_reads` are seeded numpy generators of a
population-like haplotype panel of one locus and of reads from chosen
haplotypes, for the syng read-to-genotype path.  `variation_graph` is the
`sort` path's counterpart: the GFA of such a locus as a variation graph.
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.core import arena as arena_mod
from impg_tpu_torch.core import cigar
from impg_tpu_torch.core.arena import CigarArena, DirectedRecords
from impg_tpu_torch.core.seqidx import SequenceIndex
from impg_tpu_torch.index.impg_index import ImpgIndex


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


# ---- syng read-to-genotype data --------------------------------------------

_BASES = np.frombuffer(b"ACGT", np.uint8)
_COMPLEMENT = np.zeros(256, np.uint8)
_COMPLEMENT[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, divergence: float,
           indel_share: float = 0.1, max_indel: int = 3) -> np.ndarray:
    """`seq` (uint8 ACGT letters) with `divergence` events per base: SNPs,
    and an `indel_share` of them 1..max_indel bp deletions or insertions of
    random bases, half each.  Vectorized: no per-base Python."""
    n = seq.size
    n_events = rng.binomial(n, divergence)
    pos = np.unique(rng.integers(0, n, n_events))
    kind = rng.random(pos.size)
    snp = pos[kind >= indel_share]
    out = seq.copy()
    codes = np.searchsorted(_BASES, out[snp])
    out[snp] = _BASES[(codes + rng.integers(1, 4, snp.size)) % 4]
    dels = pos[kind < indel_share / 2]
    ins = pos[(kind >= indel_share / 2) & (kind < indel_share)]
    dlen = rng.integers(1, max_indel + 1, dels.size)
    keep = np.ones(n, bool)
    drop = np.repeat(dels, dlen) + (
        np.arange(int(dlen.sum())) - np.repeat(np.cumsum(dlen) - dlen, dlen))
    keep[drop[drop < n]] = False
    ilen = rng.integers(1, max_indel + 1, ins.size)
    extra = _BASES[rng.integers(0, 4, int(ilen.sum()))]
    # Insert before each position's base, then drop the deleted ones (an
    # insertion at a deleted base still lands).
    at = np.repeat(ins, ilen)
    merged = np.insert(out, at, extra)
    keep_merged = np.insert(keep, at, np.ones(at.size, bool))
    return merged[keep_merged]


def haplotype_panel(seed: int = 5, n_haps: int = 90,
                    length: int = 1_000_000, n_founders: int = 6,
                    founder_div: float = 0.005,
                    hap_div: float = 0.0005) -> list[tuple[str, bytes]]:
    """A population-like star of `n_haps` haplotypes of one locus: a random
    base sequence of `length`, `n_founders` founders at `founder_div` from
    it, and haplotype h at `hap_div` from founder h % n_founders (SNPs plus
    1-3 bp indels).  Named hap0..hap{n_haps - 1}."""
    rng = np.random.default_rng(seed)
    base = _BASES[rng.integers(0, 4, length)]
    founders = [mutate(rng, base, founder_div) for _ in range(n_founders)]
    return [
        (f"hap{h}", mutate(rng, founders[h % n_founders], hap_div).tobytes())
        for h in range(n_haps)
    ]


def sample_reads(seed: int, haps: list[bytes], n_reads: int,
                 read_len: int = 150, error: float = 0.001) -> np.ndarray:
    """`n_reads` reads [n_reads, read_len] (uint8 letters) drawn evenly from
    the haplotypes `haps`, at uniform positions, half of them reverse
    complemented, with `error` substitutions per base."""
    rng = np.random.default_rng(seed)
    which = rng.integers(0, len(haps), n_reads)
    out = np.empty((n_reads, read_len), np.uint8)
    for h, hap in enumerate(haps):
        rows = np.nonzero(which == h)[0]
        seq = np.frombuffer(hap, np.uint8)
        starts = rng.integers(0, seq.size - read_len + 1, rows.size)
        out[rows] = seq[starts[:, None] + np.arange(read_len)]
    rc = rng.random(n_reads) < 0.5
    out[rc] = _COMPLEMENT[out[rc, ::-1]]
    err = rng.random(out.shape) < error
    codes = np.searchsorted(_BASES, out[err])
    out[err] = _BASES[(codes + rng.integers(1, 4, codes.size)) % 4]
    return out


def write_fasta(path: str, records: list[tuple[str, bytes]]) -> None:
    """One line per sequence."""
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n" + seq + b"\n")


def write_fastq(path: str, reads: np.ndarray, prefix: str = "r") -> None:
    qual = b"I" * reads.shape[1]
    with open(path, "wb") as fh:
        for i, row in enumerate(reads):
            fh.write(b"@%s%d\n%s\n+\n%s\n" % (prefix.encode(), i,
                                              row.tobytes(), qual))


# ---- sort: a variation graph of one locus ----------------------------------


def variation_graph(seed: int = 5, n_haps: int = 90,
                    locus_len: int = 1_000_000, founders: int = 6,
                    founder_div: float = 0.005, hap_div: float = 0.0005,
                    indel_share: float = 0.1, max_indel: int = 3) -> str:
    """GFA text of a locus as a variation graph of `n_haps` haplotypes.

    A random backbone of `locus_len` bases carries variant sites: each
    founder draws sites at `founder_div` per base, carried by every
    haplotype h with h % founders == f, and each haplotype draws its own at
    `hap_div`.  A site is a SNP bubble (a reference and an alternative base
    segment), or, for an `indel_share` of them, half each, a deletion of
    1..max_indel backbone bases (a segment the carriers skip) or an
    insertion of 1..max_indel random bases (a segment only the carriers
    visit).  Sites closer than one base to the previous site's end are
    dropped.  The backbone between sites is one segment.  P lines hap0..
    spell the haplotypes (forward steps); L lines are the distinct
    adjacencies of the paths.  Segment names are a random permutation of
    1..N and the S lines come in name order, so the file's order says
    nothing of the layout.  Vectorized numpy."""
    rng = np.random.default_rng(seed)
    base = _BASES[rng.integers(0, 4, locus_len)]
    # Sites: (position, carrier mask) from the founders, then the haplotypes.
    pos_parts, carrier_parts = [], []
    hap_ids = np.arange(n_haps)
    for f in range(founders):
        p = rng.integers(1, locus_len - max_indel - 1,
                         rng.binomial(locus_len, founder_div))
        pos_parts.append(p)
        carrier_parts.append(np.broadcast_to(hap_ids % founders == f,
                                             (p.size, n_haps)))
    for h in range(n_haps):
        p = rng.integers(1, locus_len - max_indel - 1,
                         rng.binomial(locus_len, hap_div))
        pos_parts.append(p)
        carrier_parts.append(np.broadcast_to(hap_ids == h, (p.size, n_haps)))
    pos = np.concatenate(pos_parts)
    carriers = np.concatenate(carrier_parts)
    pos, first = np.unique(pos, return_index=True)
    carriers = carriers[first]
    kind_draw = rng.random(pos.size)
    # 0 SNP, 1 deletion, 2 insertion
    kind = np.where(kind_draw < indel_share / 2, 1,
                    np.where(kind_draw < indel_share, 2, 0))
    length = np.where(kind == 0, 1, rng.integers(1, max_indel + 1, pos.size))
    # Backbone bases a site consumes (the insertion consumes none).
    extent = np.where(kind == 2, 0, length)
    keep = np.ones(pos.size, bool)
    end = 0
    # A site must start past the previous kept site's end (one pass).
    for k, (p, e) in enumerate(zip(pos.tolist(), extent.tolist())):
        if p <= end:
            keep[k] = False
        else:
            end = p + e
    pos, kind, length, extent, carriers = (
        pos[keep], kind[keep], length[keep], extent[keep], carriers[keep])
    n_sites = pos.size

    # Segments in layout order: backbone chunk k (from the previous site's
    # end to pos k), then site k's segment(s); a last backbone chunk.
    # Site segments: SNP -> ref (1 bp), alt (1 bp); deletion -> the deleted
    # bases; insertion -> the inserted bases.
    n_site_segs = np.where(kind == 0, 2, 1)
    seg_per_site = 1 + n_site_segs
    site_first = np.concatenate([[0], np.cumsum(seg_per_site)])[:-1]
    n_segs = int(seg_per_site.sum()) + 1
    chunk_start = np.concatenate([[0], pos[:-1] + extent[:-1]])
    seqs: list[bytes] = [b""] * n_segs
    base_b = base.tobytes()
    alt_base = _BASES[(np.searchsorted(_BASES, base[pos])
                       + rng.integers(1, 4, n_sites)) % 4].tobytes()
    ins_seq = _BASES[rng.integers(0, 4, int(length.sum()))].tobytes()
    ins_off = np.concatenate([[0], np.cumsum(length)])
    for k, (s0, p, kd, ln, sf) in enumerate(zip(
            chunk_start.tolist(), pos.tolist(), kind.tolist(),
            length.tolist(), site_first.tolist())):
        seqs[sf] = base_b[s0:p]
        if kd == 0:
            seqs[sf + 1] = base_b[p:p + 1]
            seqs[sf + 2] = alt_base[k:k + 1]
        elif kd == 1:
            seqs[sf + 1] = base_b[p:p + ln]
        else:
            seqs[sf + 1] = ins_seq[int(ins_off[k]):int(ins_off[k]) + ln]
    last_start = int(pos[-1] + extent[-1]) if n_sites else 0
    seqs[n_segs - 1] = base_b[last_start:]

    # Per site, the segment a non-carrier and a carrier visit after the
    # backbone chunk (-1: none).
    ref_seg = np.where(kind == 2, -1, site_first + 1)
    alt_seg = np.where(kind == 0, site_first + 2,
                       np.where(kind == 2, site_first + 1, -1))
    names = rng.permutation(n_segs) + 1
    tok = [f"{names[i]}+," for i in range(n_segs)]
    lines = ["H\tVN:Z:1.0"]
    by_name = np.argsort(names)
    lines += [f"S\t{names[i]}\t{seqs[i].decode()}" for i in by_name.tolist()]
    pairs = []
    paths = []
    for h in range(n_haps):
        steps = np.empty((n_sites, 2), np.int64)
        steps[:, 0] = site_first
        steps[:, 1] = np.where(carriers[:, h], alt_seg, ref_seg)
        walk = steps.reshape(-1)
        walk = np.append(walk[walk >= 0], n_segs - 1)
        pairs.append(walk[:-1] * n_segs + walk[1:])
        body = "".join([tok[i] for i in walk.tolist()])
        paths.append(f"P\thap{h}\t{body[:-1]}\t*")
    links = np.unique(np.concatenate(pairs))
    la, lb = names[links // n_segs], names[links % n_segs]
    lines += [f"L\t{a}\t+\t{b}\t+\t0M"
              for a, b in zip(la.tolist(), lb.tolist())]
    lines += paths
    return "\n".join(lines) + "\n"
