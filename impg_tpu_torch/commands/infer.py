"""Allele inference over windows with mosaic stitching
(reference: commands/infer.rs run_syng_pack_infer, docs/infer-design.md).

Per reference-range window, candidates are genotyped against the sample pack
(commands/genotype.py); the per-window top-N combinations then stitch into
phased mosaic haplotypes with a beam search that rewards cosine similarity
and penalizes haplotype switches between adjacent windows (reference
StitchMode/--switch-penalty, infer.rs:42).

Outputs: per-window call TSV + per-haplotype mosaic segments (phase blocks).

The port's copy of impg_tpu/commands/infer.py (tests/test_torch_syng_tools.py
holds the two equal).  As in impg_tpu, candidates are scored by
commands/genotype.genotype_cos on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import permutations
from typing import Optional

from impg_tpu_torch.commands import genotype as gt_mod
from impg_tpu_torch.syng.index import SyngIndex
from impg_tpu_torch.syng.pack import Pack


@dataclass
class WindowCall:
    chrom: str
    start: int
    end: int
    combos: list  # top-N CombinationScore
    candidates: list  # Candidate list for this window
    rewards: Optional[dict] = None  # candidate idx -> read-link reward


@dataclass
class MosaicSegment:
    hap_slot: int
    chrom: str
    start: int
    end: int
    source: str  # candidate genome name


def _best_perm_order(prev: tuple, nxt: tuple) -> tuple:
    """Index permutation ordering `nxt` to minimize switches vs `prev`."""
    idxs = tuple(range(len(nxt)))
    best, best_cost = idxs, len(nxt)
    for perm in permutations(idxs):
        cost = sum(1 for a, j in zip(prev, perm) if a != nxt[j])
        if cost < best_cost:
            best, best_cost = perm, cost
    return best


def stitch(
    windows: list[WindowCall],
    switch_penalty: float = 0.1,
    beam_width: int = 8,
    link_rewards: Optional[dict] = None,
) -> tuple[list[tuple], float]:
    """Beam search over per-window combinations.

    `link_rewards` maps ((win_i, cand_i), (win_j, cand_j)) -> reward for
    slot-aligned adjacent-window candidate pairs (infer.rs:1152 transition
    read-link rewards): reads whose walks support both candidates pull the
    stitching toward keeping them on the same haplotype slot.

    Known limitation: the slot permutation per transition is chosen by
    switch cost alone (_best_perm_order) BEFORE link rewards apply, so
    among cost-tied orderings the reward-maximizing slot alignment can be
    missed; the beam keeps only the cost-chosen ordering.

    Returns (chosen combination of genome-name tuples per window, score).
    """
    if not windows:
        return [], 0.0
    # States: (genome-name tuple, candidate-index tuple), slot-ordered.
    beams: list[tuple[float, list[tuple], tuple | None]] = [(0.0, [], None)]
    for wi, w in enumerate(windows):
        options = []
        for score in w.combos:
            genomes = tuple(
                w.candidates[i].genome for i in score.combination
            )
            emission = score.similarity
            if w.rewards:
                # Read-link reward per UNIQUE rewarded candidate
                # (infer.rs:602-620 candidate_read_emission aggregation).
                emission += sum(
                    w.rewards.get(i, 0.0) for i in set(score.combination)
                )
            options.append((genomes, emission, tuple(score.combination)))
        nxt_beams = []
        for acc, path, prev_idx in beams:
            prev = path[-1] if path else None
            for genomes, sim, combo in options:
                if prev is None:
                    cost = 0
                    ordered = genomes
                    ordered_idx = combo
                    link_rw = 0.0
                else:
                    order = _best_perm_order(prev, genomes)
                    ordered = tuple(genomes[j] for j in order)
                    ordered_idx = tuple(combo[j] for j in order)
                    cost = sum(1 for a, b in zip(prev, ordered) if a != b)
                    link_rw = 0.0
                    if link_rewards and prev_idx is not None:
                        for pc, cc in zip(prev_idx, ordered_idx):
                            link_rw += link_rewards.get(
                                ((wi - 1, pc), (wi, cc)), 0.0
                            )
                nxt_beams.append(
                    (
                        acc + sim - switch_penalty * cost + link_rw,
                        path + [ordered],
                        ordered_idx,
                    )
                )
        nxt_beams.sort(key=lambda x: -x[0])
        beams = nxt_beams[:beam_width]
    best_score, best_path, _ = beams[0]
    return best_path, best_score


def mosaic_segments(
    windows: list[WindowCall], path: list[tuple]
) -> list[MosaicSegment]:
    """Merge adjacent windows with the same source per haplotype slot."""
    if not windows or not path:
        return []
    ploidy = len(path[0])
    out: list[MosaicSegment] = []
    for slot in range(ploidy):
        cur: Optional[MosaicSegment] = None
        for w, genomes in zip(windows, path):
            src = genomes[slot]
            if (
                cur is not None
                and cur.source == src
                and cur.chrom == w.chrom
                and cur.end == w.start
            ):
                cur.end = w.end
            else:
                if cur is not None:
                    out.append(cur)
                cur = MosaicSegment(slot, w.chrom, w.start, w.end, src)
        if cur is not None:
            out.append(cur)
    return out


def _read_link_rewards(
    index: SyngIndex,
    read_index,
    w: "WindowCall",
    weight: float,
    min_anchors: int,
) -> dict:
    """Per-candidate read-link rewards (reference: infer.rs:775-830 read
    walk evidence + :1094 read_link_reward): each read's anchor count per
    candidate, normalized by how many candidates the read supports;
    reward = weight * 10 * log10(1 + anchor_weight)."""
    import math

    import numpy as np

    # Anchor counts per (read ordinal, candidate idx).
    per_read: dict[int, dict[int, int]] = {}
    for ci, cand in enumerate(w.candidates):
        _pos, ids, _f = index.region_syncmers(
            cand.genome, cand.start, cand.end
        )
        if not ids.size:
            continue
        for sid in np.unique(ids):
            for r in read_index.reads_with(int(sid)):
                per_read.setdefault(int(r), {}).setdefault(ci, 0)
                per_read[int(r)][ci] += 1
    anchor_weight: dict[int, float] = {}
    for counts in per_read.values():
        supported = {
            ci: c for ci, c in counts.items() if c >= min_anchors
        }
        if not supported:
            continue
        denom = float(len(supported))
        for ci, c in supported.items():
            anchor_weight[ci] = anchor_weight.get(ci, 0.0) + c / denom
    return {
        ci: weight * 10.0 * math.log10(1.0 + aw)
        for ci, aw in anchor_weight.items()
        if aw > 0.0
    }


def _candidate_walk(index: SyngIndex, universe, genome: str, start: int, end: int):
    """The candidate interval's signed dense-node walk + bp positions."""
    import numpy as np

    pos, ids, fwd = index.region_syncmers(genome, start, end)
    if not ids.size:
        return np.zeros(0, np.int32), pos
    dense = (np.searchsorted(universe, ids) + 1).astype(np.int32)
    return np.where(fwd, dense, -dense).astype(np.int32), pos


def _overlap_len(
    r_nodes, r_bpos, mem_start, mem_end, read_start, c_nodes, c_bpos, cand_start
) -> int:
    """Longest offset-consistent run around one matched node (infer.rs:886
    candidate_mem_overlap_len): extend left/right while read and candidate
    walks agree on node AND bp offset, within the MEM bounds."""
    if (
        read_start >= mem_end
        or cand_start >= len(c_nodes)
        or r_nodes[read_start] != c_nodes[cand_start]
    ):
        return 0
    rl, cl = read_start, cand_start
    while rl > mem_start and cl > 0:
        if r_nodes[rl - 1] != c_nodes[cl - 1]:
            break
        if r_bpos[rl] - r_bpos[rl - 1] != c_bpos[cl] - c_bpos[cl - 1]:
            break
        rl -= 1
        cl -= 1
    rr, cr = read_start, cand_start
    while rr + 1 < mem_end and cr + 1 < len(c_nodes):
        if r_nodes[rr + 1] != c_nodes[cr + 1]:
            break
        if r_bpos[rr + 1] - r_bpos[rr] != c_bpos[cr + 1] - c_bpos[cr]:
            break
        rr += 1
        cr += 1
    return rr - rl + 1


def _lis_len(values) -> int:
    import bisect

    tails: list = []
    for v in values:
        i = bisect.bisect_left(tails, v)
        if i == len(tails):
            tails.append(v)
        else:
            tails[i] = v
    return len(tails)


class GafEvidence:
    """Region-independent read evidence from a syng-map GAF, computed ONCE
    per (gaf, index): parsed walks and their GBWT MEMs in both
    orientations. `infer -b partitions.bed --gaf reads.gaf` reuses one
    instance across every BED row instead of re-parsing + re-MEM-matching
    per region (O(reads) total, was O(rows x reads))."""

    def __init__(self, index: SyngIndex, gaf_path: str):
        import gzip

        import numpy as np

        from impg_tpu_torch.syng.gbwt import gbwt_for_index

        gbwt = gbwt_for_index(index)
        syncmer_len = index.syncmer_len
        # Each read: ("mems", [(nodes, bpos, mems), ...both orientations])
        # or ("walk", signed_nodes).
        self.reads: list[tuple] = []
        opener = gzip.open if gaf_path.endswith(".gz") else open
        with opener(gaf_path, "rt") as fh:
            for line in fh:
                line = line.rstrip("\n")
                if not line or line.startswith("#"):
                    continue
                fields = line.split("\t")
                if len(fields) < 6:
                    raise ValueError("GAF line has fewer than 6 fields")
                signed_nodes = _parse_gaf_path(fields[5])
                qp = None
                for f in fields[12:]:
                    if f.startswith("qp:B:I"):
                        body = f[6:].lstrip(",")
                        qp = (
                            [int(x) for x in body.split(",")] if body else []
                        )
                        break
                if qp is not None and len(qp) == len(signed_nodes):
                    order = sorted(
                        range(len(qp)),
                        key=lambda i: (qp[i], signed_nodes[i]),
                    )
                    nodes = np.array(
                        [signed_nodes[i] for i in order], np.int32
                    )
                    bpos = np.array([qp[i] for i in order], np.uint64)
                    qlen = int(fields[1])
                    rev_nodes = (-nodes[::-1]).copy()
                    rev_bpos = np.maximum(
                        qlen - syncmer_len - bpos[::-1].astype(np.int64), 0
                    ).astype(np.uint64)
                    self.reads.append((
                        "mems",
                        [
                            (nodes, bpos, gbwt.mems_for_walk(nodes, bpos)),
                            (
                                rev_nodes, rev_bpos,
                                gbwt.mems_for_walk(rev_nodes, rev_bpos),
                            ),
                        ],
                    ))
                else:
                    self.reads.append(("walk", signed_nodes))


def gaf_read_walk_rewards(
    index: SyngIndex,
    gaf: "str | GafEvidence",
    windows: list[WindowCall],
    weight: float,
    min_anchors: int = 3,
) -> dict:
    """Per-candidate rewards from a syng-gaf-walk read GAF via GBWT MEMs
    (infer.rs:996 build_read_walk_evidence).  Returns the transition
    link-reward table for `stitch` (infer.rs:770 add_read_links: reads
    supporting candidates in consecutive supported calls link them).

    Every GAF row's signed-node walk is MEM-matched against the index's
    GBWT in both orientations; each MEM's steps are looked up in the
    candidate walks, scored by the longest offset-consistent overlap run,
    thresholded at `min_anchors`, normalized per read across supported
    candidates, and folded into the reward formula
    ``weight * 10 * log10(1 + anchor_weight)`` (infer.rs:1094).  Rows
    without a ``qp:B:I`` tag fall back to orientation-aware LIS hits
    (infer.rs:871 add_whole_walk_hits).

    `gaf` may be a path or a pre-built `GafEvidence` (parse + MEM cost is
    region-independent; build once, reuse across BED rows).
    """
    import math

    from impg_tpu_torch.syng.map import index_universe

    evidence = gaf if isinstance(gaf, GafEvidence) else GafEvidence(
        index, gaf
    )
    universe = index_universe(index)

    walk_index: dict[int, list[tuple[int, int, int]]] = {}
    cand_walks: dict[tuple[int, int], tuple] = {}
    for wi, w in enumerate(windows):
        for ci, cand in enumerate(w.candidates):
            nodes, bpos = _candidate_walk(
                index, universe, cand.genome, cand.start, cand.end
            )
            cand_walks[(wi, ci)] = (nodes, bpos)
            for p, n in enumerate(nodes.tolist()):
                walk_index.setdefault(n, []).append((wi, ci, p))
    if not walk_index:
        return {}

    def _mem_hits(counts, nodes, bpos, mems):
        for mem in mems:
            best: dict[tuple[int, int], int] = {}
            for ri in range(mem.step_start, mem.step_end):
                occs = walk_index.get(int(nodes[ri]))
                if not occs:
                    continue
                for wi, ci, p in occs:
                    c_nodes, c_bpos = cand_walks[(wi, ci)]
                    ov = _overlap_len(
                        nodes, bpos, mem.step_start, mem.step_end, ri,
                        c_nodes, c_bpos, p,
                    )
                    key = (wi, ci)
                    if ov > best.get(key, 0):
                        best[key] = ov
            for key, anchors in best.items():
                if anchors > 0:
                    counts[key] = counts.get(key, 0) + anchors

    def _whole_walk_hits(counts, signed_nodes):
        for oriented in (signed_nodes, [-n for n in reversed(signed_nodes)]):
            per_cand: dict[tuple[int, int], list[int]] = {}
            for n in oriented:
                for wi, ci, p in walk_index.get(n, ()):
                    per_cand.setdefault((wi, ci), []).append(p)
            for key, positions in per_cand.items():
                matched = _lis_len(positions)
                if matched:
                    counts[key] = max(counts.get(key, 0), matched)

    anchor_weight: dict[tuple[int, int], float] = {}
    link_anchor: dict[tuple, float] = {}
    for kind, payload in evidence.reads:
        counts: dict[tuple[int, int], int] = {}
        if kind == "mems":
            for nodes, bpos, mems in payload:
                _mem_hits(counts, nodes, bpos, mems)
        else:
            _whole_walk_hits(counts, payload)
        # Per-read normalization across supported candidates of a call.
        by_call: dict[int, list[tuple[int, int]]] = {}
        for (wi, ci), c in counts.items():
            if c >= max(min_anchors, 1):
                by_call.setdefault(wi, []).append((ci, c))
        for wi, hits in by_call.items():
            denom = float(len(hits))
            for ci, c in hits:
                anchor_weight[(wi, ci)] = (
                    anchor_weight.get((wi, ci), 0.0) + c / denom
                )
        # Link rewards only for ADJACENT supported windows — stitch
        # looks up ((wi-1, pc), (wi, cc)) transitions exclusively, so
        # links across a skipped window would be dead keys (evidence
        # spanning an unsupported window is consciously dropped).
        ordered_calls = sorted(by_call)
        for wa, wb in zip(ordered_calls, ordered_calls[1:]):
            if wb != wa + 1:
                continue
            prev_hits, curr_hits = by_call[wa], by_call[wb]
            pair_denom = float(len(prev_hits) * len(curr_hits))
            for ci, c1 in prev_hits:
                for cj, c2 in curr_hits:
                    key = ((wa, ci), (wb, cj))
                    link_anchor[key] = (
                        link_anchor.get(key, 0.0)
                        + min(c1, c2) / pair_denom
                    )

    for wi, w in enumerate(windows):
        rewards = {
            ci: weight * 10.0 * math.log10(1.0 + aw)
            for (wj, ci), aw in anchor_weight.items()
            if wj == wi and aw > 0.0
        }
        if rewards:
            if w.rewards:
                for ci, r in rewards.items():
                    w.rewards[ci] = w.rewards.get(ci, 0.0) + r
            else:
                w.rewards = rewards
    return {
        key: weight * 10.0 * math.log10(1.0 + aw)
        for key, aw in link_anchor.items()
        if aw > 0.0
    }


def _parse_gaf_path(path: str) -> list[int]:
    """Signed nodes from a '>12<34' GAF walk (infer.rs:642)."""
    nodes: list[int] = []
    i = 0
    while i < len(path):
        orient = path[i]
        if orient not in "><":
            raise ValueError(f"GAF path contains non-orientation byte: {path}")
        i += 1
        j = i
        while j < len(path) and path[j].isdigit():
            j += 1
        if j == i:
            raise ValueError(f"GAF path step missing numeric node: {path}")
        n = int(path[i:j])
        if n <= 0:
            raise ValueError("GAF path node must be positive")
        nodes.append(-n if orient == "<" else n)
        i = j
    return nodes


def run_infer(
    index: SyngIndex,
    pack: Pack,
    chrom: str,
    start: int,
    end: int,
    window: int = 5000,
    ploidy: int = 2,
    top_n: int = 5,
    switch_penalty: float = 0.1,
    candidate_mode: str = "overlapping",
    read_index=None,
    read_link_weight: float = 0.0,
    min_read_link_anchors: int = 3,
    gaf_path: "str | GafEvidence | None" = None,
) -> tuple[list[WindowCall], list[tuple], list[MosaicSegment]]:
    if window <= 0:
        raise ValueError(f"window must be positive (got {window})")
    windows: list[WindowCall] = []
    pos = start
    while pos < end:
        w_end = min(pos + window, end)
        if w_end - pos < window // 4 and windows:
            windows[-1].end = w_end  # merge small tail into previous window
            # Re-genotype the extended window.
            w = windows[-1]
            candidates, results = gt_mod.genotype_cos(
                index, pack, chrom, w.start, w.end,
                ploidy=ploidy, top_n=top_n, mode=candidate_mode,
            )
            w.candidates, w.combos = candidates, results
            break
        candidates, results = gt_mod.genotype_cos(
            index, pack, chrom, pos, w_end,
            ploidy=ploidy, top_n=top_n, mode=candidate_mode,
        )
        if results:
            windows.append(WindowCall(chrom, pos, w_end, results, candidates))
        pos = w_end
    if read_index is not None and read_link_weight > 0.0:
        for w in windows:
            w.rewards = _read_link_rewards(
                index, read_index, w, read_link_weight,
                min_read_link_anchors,
            )
    link_rewards = None
    if gaf_path is not None and read_link_weight > 0.0:
        link_rewards = gaf_read_walk_rewards(
            index, gaf_path, windows, read_link_weight,
            min_read_link_anchors,
        )
    path, _score = stitch(windows, switch_penalty, link_rewards=link_rewards)
    segments = mosaic_segments(windows, path)
    return windows, path, segments


def write_infer_report(out, windows, path, segments, sample="sample") -> None:
    out.write("#type\tsample\tchrom\tstart\tend\tcall\tsimilarity\tqv\n")
    for w, genomes in zip(windows, path):
        top = w.combos[0]
        # Find the score matching the chosen (unordered) combination.
        chosen = sorted(genomes)
        sim, qv = top.similarity, top.qv
        for sc in w.combos:
            g = sorted(w.candidates[i].genome for i in sc.combination)
            if g == chosen:
                sim, qv = sc.similarity, sc.qv
                break
        out.write(
            f"window\t{sample}\t{w.chrom}\t{w.start}\t{w.end}"
            f"\t{'|'.join(genomes)}\t{sim:.6f}\t{qv:.2f}\n"
        )
    for seg in segments:
        out.write(
            f"mosaic\t{sample}\t{seg.chrom}\t{seg.start}\t{seg.end}"
            f"\thap{seg.hap_slot}={seg.source}\t.\t.\n"
        )


def write_haplotype_fastas(
    windows: list[WindowCall],
    path: list[tuple],
    seq_idx,
    prefix: str,
    sample: str = "sample",
) -> list[str]:
    """Write one FASTA per haplotype slot spelling the stitched mosaic:
    per slot, consecutive same-source windows merge and the source
    genome's candidate-interval union is fetched (window-granular
    diplotype sequence output; infer.rs diplotype emission role)."""
    if not windows or not path:
        return []
    ploidy = len(path[0])
    out_paths = []
    for slot in range(ploidy):
        pieces: list[tuple[str, int, int]] = []  # (genome, lo, hi)
        for w, genomes in zip(windows, path):
            src = genomes[slot]
            ivs = [
                (c.start, c.end)
                for c in w.candidates
                if c.genome == src
            ]
            if not ivs:
                continue
            lo = min(s for s, _ in ivs)
            hi = max(e for _, e in ivs)
            if pieces and pieces[-1][0] == src and lo < pieces[-1][2]:
                pieces[-1] = (src, pieces[-1][1], max(pieces[-1][2], hi))
            else:
                pieces.append((src, lo, hi))
        p = f"{prefix}_hap{slot}.fa"
        with open(p, "w") as fh:
            for gi, (genome, lo, hi) in enumerate(pieces):
                seq = seq_idx.fetch_sequence(genome, lo, hi)
                fh.write(
                    f">{sample}#hap{slot}#{gi} {genome}:{lo}-{hi}\n"
                )
                for i in range(0, len(seq), 80):
                    fh.write(seq[i : i + 80].decode() + "\n")
        out_paths.append(p)
    return out_paths
