"""Syng-seeded transitive homology queries (reference: syng_transitive.rs —
per hop: anchor collection -> collinear chaining with gap/scaffold-mass
limits -> padded end extension -> multihop BFS with visited-range
bookkeeping matching the alignment-backed transitive walk).

The port's copy of impg_tpu/syng/transitive.py (tests/test_torch_syng_map.py
and tests/test_torch_syng_refine.py hold the two equal).  The reference
delegates chaining to SweepGA's plane-sweep scaffold filter and refines chain
ends with BiWFA; here `_sweep_chains_group` plays the SweepGA role
(gap-bounded monotone multi-chain assignment + two-axis ManyToMany plane
sweep) and `refine_chain_ends` plays the BiWFA role with the port's native
ends-free aligner (ops/align.py); without sequences, ends extend by the
bounded padding the reference falls back to below its identity floor
(syng_transitive.rs:44 MIN_ALIGNMENT_IDENTITY fallback).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from impg_tpu_torch.core.intervals import SortedRanges
from impg_tpu_torch.query.engine import Row, _merge_frontier, _too_close
from impg_tpu_torch.syng.index import SyngIndex


@dataclass
class SyngChain:
    """One collinear homology chain: query span -> target span.

    Anchor endpoints (syncmer start positions of the first/last chained
    anchor, pre-extension) feed the ends-only boundary refinement."""

    genome: str
    t_start: int
    t_end: int
    q_start: int
    q_end: int
    strand: str
    n_anchors: int
    first_q: int = -1
    first_t: int = -1
    last_q: int = -1
    last_t: int = -1


def chain_region(
    syng: SyngIndex,
    name: str,
    start: int,
    end: int,
    scaffold_gap: int = 10_000,
    min_anchors: int = 3,
    extend_budget: int = 1_000,
    drop_top_fraction: float = 0.0005,
    max_occurrences: int | None = None,
) -> list[SyngChain]:
    """Collinear homology chains for an indexed region."""
    q_abs, o_seq, o_pos, rel_fwd = syng.region_occurrences(
        name, start, end,
        drop_top_fraction=drop_top_fraction,
        max_occurrences=max_occurrences,
    )
    return chain_occurrences(
        syng, q_abs, o_seq, o_pos, rel_fwd, start, end,
        scaffold_gap=scaffold_gap,
        min_anchors=min_anchors,
        extend_budget=extend_budget,
    )


def _sweep_chains_group(
    gq: np.ndarray,
    gt: np.ndarray,
    rev: bool,
    scaffold_gap: int,
    k: int,
    overlap_threshold: float = 0.95,
) -> list[np.ndarray]:
    """SweepGA-style scaffold chaining of one (target, strand) anchor
    group (syng_transitive.rs:113 chain_anchors_with_sweepga_scaffold
    _mass role): greedy gap-bounded monotone chain assignment builds
    MULTIPLE parallel chains per target (segmental duplications produce
    one chain per copy — single-LIS keeps only the best copy), then a
    query-axis plane sweep drops chains >= `overlap_threshold` covered by
    a heavier chain.  Returns anchor index arrays, one per kept chain."""
    order = np.lexsort((gt, gq))
    gq, gt = gq[order], gt[order]
    tdir = -1 if rev else 1
    # Diagonal drift budget per step: far tighter than the scaffold gap so
    # parallel duplicated copies stay separate chains (the role of
    # sweepga's per-scaffold deviation bound).
    max_dev = max(2 * k, scaffold_gap // 8)
    chains: list[list[int]] = []
    last_q: list[int] = []
    last_t: list[int] = []
    active: list[int] = []  # chains whose last_q can still be reached
    for i in range(gq.size):
        q, t = int(gq[i]), int(gt[i])
        best = -1
        best_dev = None
        still_active = []
        for c in active:
            dq = q - last_q[c]
            if dq > scaffold_gap:
                # Anchors arrive in nondecreasing q: this chain can never
                # accept another anchor — retire it (keeps repeat-dense
                # groups near-linear instead of quadratic).
                continue
            still_active.append(c)
            dt = (t - last_t[c]) * tdir
            if dq < 0 or dt < 0 or dt > scaffold_gap:
                continue
            dev = abs(dq - dt)
            if dev > max_dev:
                continue
            if best_dev is None or dev < best_dev:
                best, best_dev = c, dev
        active = still_active
        if best < 0:
            chains.append([i])
            last_q.append(q)
            last_t.append(t)
            active.append(len(chains) - 1)
        else:
            chains[best].append(i)
            last_q[best] = q
            last_t[best] = t
    # Two-axis plane sweep (ManyToMany): heavier chains win; a chain is
    # redundant only when a kept chain covers >= threshold of BOTH its
    # query span and its target span — duplicated copies at distinct
    # target loci all survive.
    spans = []
    for c, idxs in enumerate(chains):
        qs = int(gq[idxs[0]])
        qe = int(gq[idxs[-1]]) + k
        arr = np.asarray(idxs)
        ts = int(gt[arr].min())
        te = int(gt[arr].max()) + k
        spans.append((len(idxs), qs, qe, ts, te, c))
    spans.sort(key=lambda s: (-s[0], s[1]))
    kept: list[tuple[int, int, int, int]] = []
    out = []
    for n, qs, qe, ts, te, c in spans:
        redundant = False
        for ks, ke, kts, kte in kept:
            q_cov = min(qe, ke) - max(qs, ks)
            t_cov = min(te, kte) - max(ts, kts)
            if (
                q_cov >= overlap_threshold * max(qe - qs, 1)
                and t_cov >= overlap_threshold * max(te - ts, 1)
            ):
                redundant = True
                break
        if redundant:
            continue
        kept.append((qs, qe, ts, te))
        out.append(order[np.asarray(chains[c], np.int64)])
    return out


def chain_occurrences(
    syng: SyngIndex,
    q_abs: np.ndarray,
    o_seq: np.ndarray,
    o_pos: np.ndarray,
    rel_fwd: np.ndarray,
    start: int,
    end: int,
    scaffold_gap: int = 10_000,
    min_anchors: int = 3,
    extend_budget: int = 1_000,
) -> list[SyngChain]:
    """Chain pre-gathered anchor occurrences (query frame [start, end)) —
    shared by indexed-region chains and external read mapping."""
    if o_seq.size == 0:
        return []
    k = syng.syncmer_len
    strand_code = np.where(rel_fwd, 0, 1)
    order = np.lexsort((o_pos, q_abs, strand_code, o_seq))
    q_abs, o_seq, o_pos, strand_code = (
        q_abs[order], o_seq[order], o_pos[order], strand_code[order]
    )
    group_bounds = np.nonzero(
        (o_seq[1:] != o_seq[:-1]) | (strand_code[1:] != strand_code[:-1])
    )[0]
    starts = np.concatenate([[0], group_bounds + 1])
    ends = np.concatenate([group_bounds + 1, [o_seq.size]])

    out: list[SyngChain] = []
    for gs, ge in zip(starts, ends):
        gq = q_abs[gs:ge]
        gt = o_pos[gs:ge]
        rev = bool(strand_code[gs])
        genome = syng.seq_index.get_name(int(o_seq[gs]))
        hid = int(o_seq[gs])
        seq_len = syng.seq_index.get_len_from_id(hid)
        # SweepGA-style scaffold chaining: every gap-bounded monotone
        # chain survives the plane sweep independently, so duplicated
        # copies on the same target each produce a chain (the old
        # single-LIS kept only the longest copy).
        for idxs in _sweep_chains_group(gq, gt, rev, scaffold_gap, k):
            n = len(idxs)
            if n < min_anchors:
                continue
            cq = gq[idxs]
            ct = gt[idxs]
            q0, q1 = int(cq[0]), int(cq[-1]) + k
            tmin = int(ct.min())
            tmax = int(ct.max()) + k
            # Bounded padded end extension toward the region bounds
            # (the reference's sub-identity fallback path).
            ext_l = min(extend_budget, max(q0 - start, 0))
            ext_r = min(extend_budget, max(end - q1, 0))
            q0 -= ext_l
            q1 += ext_r
            if rev:
                tmin -= ext_r
                tmax += ext_l
            else:
                tmin -= ext_l
                tmax += ext_r
            tmin = max(tmin, 0)
            tmax = min(tmax, seq_len)
            out.append(
                SyngChain(
                    genome=genome,
                    t_start=tmin,
                    t_end=tmax,
                    q_start=q0,
                    q_end=q1,
                    strand="-" if rev else "+",
                    n_anchors=n,
                    first_q=int(cq[0]),
                    first_t=int(ct[0]),
                    last_q=int(cq[-1]),
                    last_t=int(ct[-1]),
                )
            )
    return out


def _entry(
    visited: dict[int, SortedRanges], syng: SyngIndex, sid: int
) -> SortedRanges:
    r = visited.get(sid)
    if r is None:
        r = SortedRanges(
            sequence_length=syng.seq_index.get_len_from_id(sid) or 0,
            min_distance=0,
        )
        visited[sid] = r
    return r


def refine_chain_ends(
    syng: SyngIndex,
    chains: list[SyngChain],
    seq_idx,
    qname: str,
    start: int,
    end: int,
    extend_budget: int = 1_000,
    min_alignment_identity: float = 0.3,
) -> None:
    """Ends-only boundary refinement (syng_transitive.rs:485
    refine_ends_only): per chain, two ends-free extensions with the native
    aligner — from the first anchor backward to the query region start and
    from the last anchor forward to the region end — replace the padded
    linear extrapolation of the chain's target bounds.  The chained
    interior is trusted (every interior anchor is a syncmer match).
    Refinements whose matched fraction falls below
    `min_alignment_identity` keep the padded bounds (the reference's
    syncmer-noise fallback).  Gaps under 64 bp skip alignment — linear
    drift over that span is negligible (SKIP_BIWFA_MIN_GAP)."""
    from impg_tpu_torch.io.fasta import reverse_complement
    from impg_tpu_torch.ops.align import align_extend

    SKIP_MIN_GAP = 64
    k = syng.syncmer_len
    qseq = seq_idx.fetch_sequence(qname, start, end)

    def window(gap: int) -> int:
        slop = min(max(gap // 20, 32), extend_budget)
        return max(min(gap + slop, 2 * extend_budget), k)

    for c in chains:
        if c.first_q < 0:
            continue
        t_len = syng.seq_index.get_len_from_id(
            syng.seq_index.get_id(c.genome)
        )
        # --- query-left gap: region start .. first anchor ---
        gap_l = c.first_q - start
        if gap_l >= SKIP_MIN_GAP:
            w = window(gap_l)
            # The query segment is bounded like the target window: only
            # the portion ADJACENT to the anchor aligns (an unbounded gap
            # would overflow the native aligner's cell cap, and identity
            # over a segment longer than the window is unsatisfiable).
            seg_len = min(gap_l, w)
            q_off = c.first_q - start
            q_seg = qseq[q_off - seg_len : q_off]
            if c.strand == "+":
                lo = max(c.first_t - w, 0)
                tgt = seq_idx.fetch_sequence(c.genome, lo, c.first_t)
                consumed, matches = align_extend(
                    q_seg[::-1], tgt[::-1]
                )
                if matches / max(len(q_seg), 1) >= min_alignment_identity:
                    c.t_start = c.first_t - consumed
                    c.q_start = c.first_q - seg_len
            else:
                hi = min(c.first_t + k + w, t_len)
                tgt = seq_idx.fetch_sequence(c.genome, c.first_t + k, hi)
                consumed, matches = align_extend(
                    reverse_complement(q_seg), tgt
                )
                if matches / max(len(q_seg), 1) >= min_alignment_identity:
                    c.t_end = c.first_t + k + consumed
                    c.q_start = c.first_q - seg_len
        # --- query-right gap: last anchor end .. region end ---
        gap_r = end - (c.last_q + k)
        if gap_r >= SKIP_MIN_GAP:
            w = window(gap_r)
            seg_len = min(gap_r, w)
            q_off = c.last_q + k - start
            q_seg = qseq[q_off : q_off + seg_len]
            if c.strand == "+":
                hi = min(c.last_t + k + w, t_len)
                tgt = seq_idx.fetch_sequence(c.genome, c.last_t + k, hi)
                consumed, matches = align_extend(q_seg, tgt)
                if matches / max(len(q_seg), 1) >= min_alignment_identity:
                    c.t_end = c.last_t + k + consumed
                    c.q_end = c.last_q + k + seg_len
            else:
                lo = max(c.last_t - w, 0)
                tgt = seq_idx.fetch_sequence(c.genome, lo, c.last_t)
                consumed, matches = align_extend(
                    reverse_complement(q_seg)[::-1], tgt[::-1]
                )
                if matches / max(len(q_seg), 1) >= min_alignment_identity:
                    c.t_start = c.last_t - consumed
                    c.q_end = c.last_q + k + seg_len
        c.t_start = max(c.t_start, 0)
        c.t_end = min(c.t_end, t_len)


def _entry(
    visited: dict[int, SortedRanges], syng: SyngIndex, sid: int
) -> SortedRanges:
    r = visited.get(sid)
    if r is None:
        r = SortedRanges(
            sequence_length=syng.seq_index.get_len_from_id(sid) or 0,
            min_distance=0,
        )
        visited[sid] = r
    return r


def query_transitive(
    syng: SyngIndex,
    name: str,
    start: int,
    end: int,
    max_depth: int = 2,
    min_transitive_len: int = 101,
    min_distance_between_ranges: int = 10,
    scaffold_gap: int = 10_000,
    min_anchors: int = 3,
    extend_budget: int = 1_000,
    seq_idx=None,
) -> list[Row]:
    """Multihop homology walk with visited-range bookkeeping mirroring the
    alignment-backed `query_transitive_bfs` semantics (same
    min-transitive-length and min-distance snapping rules).

    With `seq_idx` (sequence access), every hop's chains get ends-only
    boundary refinement with the native aligner instead of padded linear
    extrapolation (syng_transitive.rs:485 refine_ends_only role)."""
    qid = syng.seq_index.get_id(name)
    if qid is None:
        raise KeyError(f"Sequence '{name}' not found in syng index")
    visited: dict[int, SortedRanges] = {}
    results: list[Row] = []
    current: list[tuple[int, int, int]] = []
    for s, e in _entry(visited, syng, qid).insert((start, end)):
        results.append(Row(qid, s, e, None, qid, s, e))
        if abs(e - s) >= min_transitive_len:
            current.append((qid, s, e))

    depth = 0
    while current and (max_depth == 0 or depth < max_depth):
        nxt: list[tuple[int, int, int]] = []
        for tid, s, e in current:
            tname = syng.seq_index.get_name(tid)
            hop_chains = chain_region(
                syng, tname, s, e,
                scaffold_gap=scaffold_gap,
                min_anchors=min_anchors,
                extend_budget=extend_budget,
            )
            if seq_idx is not None:
                refine_chain_ends(
                    syng, hop_chains, seq_idx, tname, s, e,
                    extend_budget=extend_budget,
                )
            for ch in hop_chains:
                hid = syng.seq_index.get_id(ch.genome)
                if hid is None:
                    continue
                if ch.strand == "-":
                    q_first, q_last = ch.t_end, ch.t_start
                else:
                    q_first, q_last = ch.t_start, ch.t_end
                results.append(
                    Row(hid, q_first, q_last, None, tid, ch.q_start, ch.q_end)
                )
                ranges = _entry(visited, syng, hid)
                lo, hi = ch.t_start, ch.t_end
                if _too_close(ranges, lo, hi, min_distance_between_ranges):
                    continue
                for ns, ne in ranges.insert((lo, hi)):
                    if abs(ne - ns) >= min_transitive_len:
                        nxt.append((hid, ns, ne))
        depth += 1
        # Merge adjacent/overlapping same-sequence frontier entries before
        # the next hop (the alignment-backed walker's _merge_frontier
        # contract) — unmerged fragments would chain separately and drop
        # homologs whose anchors straddle the artificial boundary.
        current = _merge_frontier(nxt)
    return results
