"""All-vs-all sparse alignment: FASTA -> PAF with base-level CIGARs
(reference: commands/align.rs, which drives sweepga/wfmash/FastGA
subprocesses; here the pipeline is native: syncmer anchors + chaining +
native gap alignment).

Per ordered sequence pair with enough shared syncmer anchors:
  1. anchors = shared canonical syncmers (query pos, target pos, rel strand),
     taken from the syng occurrence index;
  2. reverse-strand pairs are lifted into RC-query coordinates so chaining
     and alignment run forward/forward (PAF '-' convention);
  3. chaining = longest increasing subsequence over target positions of the
     query-sorted anchors, split at gaps larger than `max_gap`;
  4. every anchor is verified base-exact (hash collisions dropped) and
     contributes an '=' run; inter-anchor gaps align with the native
     affine-gap aligner (ops/align.py);
  5. each chain emits one PAF row with cg:Z: runs.

The port's copy of impg_tpu/commands/align.py (tests/test_torch_seqwish.py
holds `align_sequence_pair` and `select_pairs` equal): anchors from the port's
host `SyngIndex` (its syncmers from the host extractor), gaps through the
port's native aligner.  The `align` subcommand that wraps `run_align` is not
ported yet; region graphs (graph/region.py) and crush call the functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from impg_tpu_torch.core import cigar
from impg_tpu_torch.io.fasta import reverse_complement
from impg_tpu_torch.ops.align import DEFAULT_SCORING, align_pair
from impg_tpu_torch.syng.index import SyngIndex


@dataclass
class AlignConfig:
    min_anchors: int = 3
    max_gap: int = 10_000
    min_chain_span: int = 100
    scoring: tuple = DEFAULT_SCORING
    drop_top_fraction: float = 0.0005
    # Pair sparsification: none | random:P | knn:K (align.rs:26 role).
    sparsify: str = "none"
    mash_k: int = 15
    sketch_size: int = 1000


def _lis_chain(q_pos: np.ndarray, t_pos: np.ndarray) -> list[int]:
    """Indices of a longest strictly-increasing chain of t_pos over
    q_pos-sorted anchors (O(n log n) patience LIS with backpointers)."""
    import bisect

    n = q_pos.size
    tails: list[int] = []  # anchor index whose t_pos ends the pile
    tails_vals: list[int] = []
    back = [-1] * n
    for i in range(n):
        v = int(t_pos[i])
        j = bisect.bisect_left(tails_vals, v)
        if j > 0:
            back[i] = tails[j - 1]
        if j == len(tails):
            tails.append(i)
            tails_vals.append(v)
        else:
            tails[j] = i
            tails_vals[j] = v
    if not tails:
        return []
    out = []
    cur = tails[-1]
    while cur != -1:
        out.append(cur)
        cur = back[cur]
    out.reverse()
    return out


def _pair_anchors(
    index: SyngIndex, qname: str, tname: str,
    drop_top_fraction: float = 0.0005,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(q_pos, t_pos, rel_fwd) anchors between two indexed sequences —
    the vectorized, seed-frequency-filtered occurrence primitive
    (occurrences_for_syncmers), restricted to the target sequence.  The
    filter keeps high-copy repeat seeds from exploding anchor counts
    (the reference's SyngSeedFilter role, syng.rs:1866)."""
    qid = index.seq_index.get_id(qname)
    tid = index.seq_index.get_id(tname)
    q_len = index.seq_index.get_len_from_id(qid)
    q_pos_all, ids, fwd = index.region_syncmers(qname, 0, q_len)
    q_abs, o_seq, o_pos, rel_fwd = index.occurrences_for_syncmers(
        q_pos_all, ids, fwd, drop_top_fraction=drop_top_fraction
    )
    sel = o_seq == tid
    return q_abs[sel], o_pos[sel], rel_fwd[sel]


def align_sequence_pair(
    index: SyngIndex,
    seqs: dict[str, bytes],
    qname: str,
    tname: str,
    config: AlignConfig = AlignConfig(),
) -> list[dict]:
    """PAF-row dicts for every chained alignment between two sequences."""
    L = index.syncmer_len
    q_seq = seqs[qname]
    t_seq = seqs[tname]
    q_len, t_len = len(q_seq), len(t_seq)
    q_pos, t_pos, rel_fwd = _pair_anchors(
        index, qname, tname, drop_top_fraction=config.drop_top_fraction
    )
    rows = []

    for strand, mask in (("+", rel_fwd), ("-", ~rel_fwd)):
        qp = q_pos[mask].astype(np.int64)
        tp = t_pos[mask].astype(np.int64)
        if qp.size < config.min_anchors:
            continue
        # Work in RC-query frame for '-' so both axes ascend together.
        work_q = reverse_complement(q_seq) if strand == "-" else q_seq
        wq = (q_len - qp - L) if strand == "-" else qp

        # Verify anchors base-exact (canonical-id collisions are dropped).
        keep = np.fromiter(
            (
                work_q[int(a) : int(a) + L] == t_seq[int(b) : int(b) + L]
                for a, b in zip(wq, tp)
            ),
            bool,
            count=wq.size,
        )
        wq, tp = wq[keep], tp[keep]
        if wq.size < config.min_anchors:
            continue
        order = np.argsort(wq, kind="stable")
        wq, tp = wq[order], tp[order]
        chain = _lis_chain(wq, tp)
        if len(chain) < config.min_anchors:
            continue

        # Split the chain at large gaps; emit one row per sub-chain.
        sub: list[int] = []
        subchains: list[list[int]] = []
        for idx in chain:
            if sub:
                pg = wq[idx] - wq[sub[-1]]
                tg = tp[idx] - tp[sub[-1]]
                if pg > config.max_gap or tg > config.max_gap:
                    subchains.append(sub)
                    sub = []
            sub.append(idx)
        if sub:
            subchains.append(sub)

        from impg_tpu_torch.query.merge import merge_consecutive_runs

        def emit(runs_parts, row_q_start, row_t_start, row_q_end,
                 row_t_end):
            if not runs_parts:
                return
            if row_q_end - row_q_start < config.min_chain_span:
                return
            runs = merge_consecutive_runs(np.concatenate(runs_parts))
            # Map RC-frame coords back to forward query coords for PAF.
            if strand == "-":
                pq_start = q_len - row_q_end
                pq_end = q_len - row_q_start
            else:
                pq_start, pq_end = row_q_start, row_q_end
            lens = cigar.run_len(runs)
            ops = cigar.run_op(runs)
            matches = int(lens[ops == cigar.OP_EQ].sum())
            block = int(lens.sum())
            rows.append(
                dict(
                    qname=qname,
                    qlen=q_len,
                    qstart=pq_start,
                    qend=pq_end,
                    strand=strand,
                    tname=tname,
                    tlen=t_len,
                    tstart=row_t_start,
                    tend=row_t_end,
                    matches=matches,
                    block=block,
                    runs=runs,
                )
            )

        for sub in subchains:
            if len(sub) < config.min_anchors:
                continue
            a0, a1 = sub[0], sub[-1]
            if wq[a1] + L - wq[a0] < config.min_chain_span:
                continue
            runs_parts: list[np.ndarray] = []
            prev_q = int(wq[a0])
            prev_t = int(tp[a0])
            row_q_start = prev_q
            row_t_start = prev_t
            for idx in sub:
                aq, at_ = int(wq[idx]), int(tp[idx])
                if aq < prev_q or at_ < prev_t:
                    continue  # overlapping anchor; skip
                gap_q = work_q[prev_q:aq]
                gap_t = t_seq[prev_t:at_]
                if gap_q or gap_t:
                    try:
                        runs_parts.append(
                            align_pair(gap_q, gap_t, config.scoring)
                        )
                    except ValueError:
                        # Gap beyond the aligner's budget: SPLIT the chain
                        # here (emit what accumulated, restart at this
                        # anchor) instead of dropping the whole row.
                        emit(runs_parts, row_q_start, row_t_start,
                             prev_q, prev_t)
                        runs_parts = []
                        row_q_start, row_t_start = aq, at_
                        prev_q, prev_t = aq, at_
                runs_parts.append(
                    cigar.pack(
                        np.array([L], np.int64),
                        np.array([cigar.OP_EQ], np.uint32),
                    )
                )
                prev_q, prev_t = aq + L, at_ + L
            emit(runs_parts, row_q_start, row_t_start, prev_q, prev_t)
    return rows


def run_align(
    fasta_files: list[str],
    out,
    config: AlignConfig = AlignConfig(),
    pairs: Optional[list[tuple[str, str]]] = None,
) -> int:
    """Align every ordered sequence pair with shared anchors; write PAF."""
    from impg_tpu_torch.io.fasta import FastaIndex

    fa = FastaIndex.build_from_files(fasta_files)
    names = list(fa.sequence_names())
    seqs = {
        n: fa.fetch_sequence(n, 0, fa.get_sequence_length(n)) for n in names
    }
    index = SyngIndex.build(list(seqs.items()))

    if pairs is None:
        pairs = select_pairs(
            names, seqs, getattr(config, "sparsify", "none"),
            mash_k=getattr(config, "mash_k", 15),
            sketch_size=getattr(config, "sketch_size", 1000),
        )
    n_rows = 0
    for qname, tname in pairs:
        for row in align_sequence_pair(index, seqs, qname, tname, config):
            text = cigar.format_runs(row["runs"])
            out.write(
                f"{row['qname']}\t{row['qlen']}\t{row['qstart']}\t{row['qend']}"
                f"\t{row['strand']}\t{row['tname']}\t{row['tlen']}"
                f"\t{row['tstart']}\t{row['tend']}\t{row['matches']}"
                f"\t{row['block']}\t255\tcg:Z:{text}\n"
            )
            n_rows += 1
    return n_rows


# ── mash-sketch pair sparsification (reference: commands/align.rs:104
# generate_pairs_for_sequences via sweepga::mash bottom-k sketches +
# knn_graph haplotype-aware selection) ─────────────────────────────────


def _hash_kmers(seq: bytes, k: int) -> np.ndarray:
    """Unique canonical k-mer hashes (splitmix-style finalizer)."""
    from impg_tpu_torch.ops import syncmer as sm

    code = sm.encode_bases(seq).astype(np.int64)
    n = code.size - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    bad = (code < 0) | (code >= 4)
    invalid_win = np.convolve(bad.astype(np.int32), np.ones(k, np.int32))[
        k - 1 : k - 1 + n
    ]
    valid = invalid_win == 0
    safe = np.where(bad, 0, code)
    idx = np.arange(n)
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    rc = 3 - safe
    for j in range(k):
        fwd = fwd << np.uint64(2) | safe[idx + j].astype(np.uint64)
        rev = rev << np.uint64(2) | rc[idx + k - 1 - j].astype(np.uint64)
    canon = np.minimum(fwd, rev)[valid]
    x = canon * np.uint64(0x9E3779B97F4A7C15)
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    return np.unique(x)


def mash_sketch(seq: bytes, k: int = 15, sketch_size: int = 1000) -> np.ndarray:
    """Bottom-k sketch: the `sketch_size` smallest canonical k-mer hashes."""
    h = _hash_kmers(seq, k)
    if h.size > sketch_size:
        h = np.partition(h, sketch_size)[:sketch_size]
        h.sort()
    return h


def mash_distance(a: np.ndarray, b: np.ndarray, k: int = 15) -> float:
    """Mash distance from the merged bottom-k jaccard estimate."""
    if a.size == 0 or b.size == 0:
        return 1.0
    s = min(a.size, b.size)
    merged = np.union1d(a, b)[:s]
    shared = np.intersect1d(a, b, assume_unique=True)
    j = float(np.isin(merged, shared, assume_unique=True).sum()) / s
    if j <= 0.0:
        return 1.0
    import math

    return min(1.0, -math.log(2.0 * j / (1.0 + j)) / k)


def _pansn_group(name: str) -> str:
    """PanSN SAMPLE#HAPLOTYPE grouping key (contig-level fallback)."""
    parts = name.split("#")
    return "#".join(parts[:2]) if len(parts) >= 3 else name


def select_pairs(
    names: list[str],
    seqs: dict[str, bytes],
    strategy: str = "none",
    mash_k: int = 15,
    sketch_size: int = 1000,
    rng_seed: int = 42,
) -> list[tuple[str, str]]:
    """Ordered alignment pairs under a sparsification strategy:

      none       — all ordered pairs (dense)
      random:P   — keep each unordered pair with probability P
      knn:K      — each group keeps its K nearest groups by mash distance
                   (the connectivity-backbone role of the reference's
                   default Connectivity strategy)

    Groups follow PanSN SAMPLE#HAPLOTYPE prefixes, falling back to one
    group per contig for non-PanSN names; selected group pairs expand to
    all cross-group contig pairs, both orders.
    """
    groups: dict[str, list[str]] = {}
    for n in names:
        groups.setdefault(_pansn_group(n), []).append(n)
    gnames = list(groups)
    n_g = len(gnames)
    if strategy == "none" or n_g <= 1:
        return [(q, t) for q in names for t in names if q != t]

    selected: set[tuple[int, int]] = set()
    if strategy.startswith("random:"):
        p = float(strategy.split(":", 1)[1])
        rng = np.random.default_rng(rng_seed)
        for i in range(n_g):
            for j in range(i + 1, n_g):
                if rng.random() < p:
                    selected.add((i, j))
    elif strategy.startswith("knn:"):
        kk = int(strategy.split(":", 1)[1])
        sketches = []
        for g in gnames:
            h = np.concatenate(
                [_hash_kmers(seqs[n], mash_k) for n in groups[g]]
            )
            h = np.unique(h)
            if h.size > sketch_size:
                h = np.partition(h, sketch_size)[:sketch_size]
                h.sort()
            sketches.append(h)
        for i in range(n_g):
            d = [
                (mash_distance(sketches[i], sketches[j], mash_k), j)
                for j in range(n_g)
                if j != i
            ]
            d.sort()
            for _, j in d[:kk]:
                selected.add((min(i, j), max(i, j)))
    else:
        raise ValueError(
            f"unknown sparsification strategy '{strategy}' "
            "(expected none, random:P, knn:K)"
        )

    pairs: list[tuple[str, str]] = []
    for i, j in sorted(selected):
        for a in groups[gnames[i]]:
            for b in groups[gnames[j]]:
                pairs.append((a, b))
                pairs.append((b, a))
    # Intra-group pairs always align (haplotypes of one sample).
    for g in gnames:
        members = groups[g]
        for a in members:
            for b in members:
                if a != b:
                    pairs.append((a, b))
    return pairs
