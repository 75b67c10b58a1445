"""Crush: bubble-bounded local graph resolution (reference: resolution.rs
resolve_gfa_bubbles — POVU flubble discovery + tiered POA/POASTA/pairwise
realignment with exact path validation, iterated to a fixed point).

Round-2 design (local resolution, no global bail):

  - anchors: nodes every order-consistent path traverses exactly once
    (computed from path walks, not topology — robust to spurious edges);
  - every path is additionally bounded by VIRTUAL start/end anchors, so
    prefix/suffix regions and whole-component bubbles (graphs with no
    shared anchors at all) resolve too — the reference's top-level
    flubble case (resolution.rs:997 resolve_gfa_bubbles top-level sites);
  - paths are classified per round: participants (contain every anchor
    once, in order) are sliced normally; floaters (contain NO anchor
    node) join as whole-walk alleles of the virtual region; anything
    else (partial/duplicated anchor usage, e.g. scrambled or RC walks)
    is left untouched LOCALLY — it degrades only the regions it shares
    nodes with (via the reclaim accounting), never the whole graph;
  - the region between consecutive anchors is a bubble when at least two
    paths spell different sequences through it; tiers: native convex-gap
    POA up to `max_span`, syncmer-anchored pairwise induction + seqwish
    beyond (resolution.rs' 3-tier POA/POASTA/pairwise dispatch role);
  - per-region do-no-harm cost gate (bp + per-node charge) — an accepted
    realignment SPLICES into the standing graph; rejected regions stay;
  - after the main rounds converge, one POLISH round retries each
    candidate region's POA under multiple sequence orderings and keeps
    the cheapest accepted result (the bounded-POASTA polish tier role,
    resolution.rs ResolutionPolishMethod — POA is order-sensitive, so
    reordering recovers splits the greedy first pass left behind);
  - path spellings are validated EXACTLY after every round (the
    reference's contract); rounds repeat until no bubble changes.

The port's copy of impg_tpu/graph/crush.py (tests/test_torch_graph_pipeline.py
holds the graph and its CrushStats equal).  Block POA runs on a thread pool
whose results are applied in block order; the columnar rounds spell through
the port's native `spell_steps`, which raises without the native library
(impg_tpu's numpy spelling fallback behind it is not copied: the columnar
round runs only where the native tokenizer parsed the graph).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

from impg_tpu_torch.graph import poa as poa_mod
from impg_tpu_torch.graph.gfa import Gfa
from impg_tpu_torch.io.fasta import reverse_complement


@dataclass
class CrushStats:
    rounds: int = 0
    bubbles_seen: int = 0
    bubbles_resolved: int = 0
    nodes_before: int = 0
    nodes_after: int = 0
    bp_before: int = 0
    bp_after: int = 0
    excluded_paths: int = 0  # paths whose walk disagreed (e.g. inversions)
    polish_gains: int = 0  # regions improved by the polish ordering retry


# Per-node charge in the region-acceptance cost (bp-equivalent overhead
# of one more segment: S-line + links + step bookkeeping downstream).
# Calibrated on the reference's own fixtures: 6 accepts a 2x bp
# compression of real diverged C4 alleles (nested_bubbles_real: 780 bp /
# 32 nodes -> 376 bp / 90 nodes) while still rejecting microtangle
# confetti (mid_insertion_200bp POA: 347 bp / 300 nodes loses to the
# affix split's 446 bp / 4 nodes).
_NODE_COST = 6

# Virtual anchors bounding every path walk ('\x00' cannot appear in a GFA
# segment name, so these can never collide with real steps).
_VSTART = ("\x00^", False)
_VEND = ("\x00$", False)


def _step_seq(gfa: Gfa, step) -> bytes:
    s = gfa.segments[step[0]].encode()
    return reverse_complement(s) if step[1] else s


def _find_anchors(gfa: Gfa) -> tuple[list, set]:
    """(anchors, participating path names).

    Anchors are oriented steps every PARTICIPATING path contains exactly
    once, in a consistent order.  Paths whose walks disagree with the first
    path's orientation/order (e.g. reverse-complement members) are excluded
    and handled locally by the caller (their regions stay untouched).
    """
    if not gfa.paths:
        return [], set()
    per_path_once: list[set] = []
    for _, steps in gfa.paths:
        seen: dict = {}
        for st in steps:
            seen[st] = seen.get(st, 0) + 1
        per_path_once.append({st for st, c in seen.items() if c == 1})

    participating = [0]
    candidate = set(per_path_once[0])
    order0 = [st for st in gfa.paths[0][1] if st in candidate]
    index0 = {st: i for i, st in enumerate(order0)}
    for pi in range(1, len(gfa.paths)):
        shared = per_path_once[pi] & candidate
        seq = [index0[st] for st in gfa.paths[pi][1] if st in shared]
        if not seq:
            continue
        inc = sum(1 for a, b in zip(seq, seq[1:]) if b > a)
        # A single shared step cannot disagree with any order.
        if len(seq) < 2 or inc >= 0.5 * (len(seq) - 1):
            participating.append(pi)
    candidate = set(per_path_once[participating[0]])
    for pi in participating[1:]:
        candidate &= per_path_once[pi]
    first = [st for st in gfa.paths[0][1] if st in candidate]
    index0 = {st: i for i, st in enumerate(first)}
    ok = set(first)
    for pi in participating[1:]:
        last = -1
        for st in gfa.paths[pi][1]:
            if st not in index0:
                continue
            if index0[st] < last:
                ok.discard(st)
            else:
                last = index0[st]
    names = {gfa.paths[pi][0] for pi in participating}
    return [st for st in first if st in ok], names


def _induce_block(names: list[str], seqs: list[bytes]) -> str:
    """Pairwise-induction realignment of one oversized region: all-vs-all
    syncmer-anchored native alignment + seqwish transitive closure (the
    large-bubble tier of resolution.rs' POA/POASTA/pairwise dispatch)."""
    from impg_tpu_torch.commands import align as align_mod
    from impg_tpu_torch.graph import seqwish as seqwish_mod
    from impg_tpu_torch.syng.index import SyngIndex

    sdict = dict(zip(names, seqs))
    syng = SyngIndex.build(list(sdict.items()))
    keys = list(sdict)
    if len(keys) > 8:
        # Mash-kNN pair sampling (the resolution.rs pairwise tier samples
        # pairs via Mash kNN trees + a random fraction instead of aligning
        # all O(n^2) allele pairs): each allele aligns to its 4 nearest by
        # mash distance, both orders.  Sparser induction still yields a
        # valid exact-spelling graph (seqwish union-find), and the caller's
        # do-no-harm cost gate rejects poor compressions.
        from impg_tpu_torch.commands.align import select_pairs

        pairs = select_pairs(keys, sdict, strategy="knn:4")
    else:
        pairs = [(q, t) for q in keys for t in keys if q != t]
    rows = []
    for q, t in pairs:
        rows.extend(align_mod.align_sequence_pair(syng, sdict, q, t))
    gfa = seqwish_mod.induce_graph(sdict, rows)
    # induce_graph names paths `key:0-len`; the keys already carry their
    # lace ranges, so strip the redundant suffix.
    fixed = []
    for line in gfa.splitlines():
        if line.startswith("P\t"):
            parts = line.split("\t")
            base, _, suffix = parts[1].rpartition(":")
            if suffix.startswith("0-") and base in sdict:
                parts[1] = base
            fixed.append("\t".join(parts))
        else:
            fixed.append(line)
    return "\n".join(fixed) + "\n"


def _pair_block(s0: bytes, s1: bytes) -> tuple[Gfa, int] | None:
    """(block, shared bp) from one native pairwise alignment: '=' runs
    are shared nodes, X/I/D runs private lanes. Consecutive
    same-membership runs merge (unchop). None when the native aligner is
    unavailable."""
    from impg_tpu_torch.core import cigar as cigar_mod

    try:
        from impg_tpu_torch.ops.align import align_pair

        runs = align_pair(s0, s1)
    except (RuntimeError, ValueError):
        return None
    lens = cigar_mod.run_len(runs)
    ops = cigar_mod.run_op(runs)
    g = Gfa()
    steps0: list[tuple[str, bool]] = []
    steps1: list[tuple[str, bool]] = []
    p0 = p1 = 0
    nid = 0
    # Pending private pieces merge until a shared node flushes them.
    pend0: list[bytes] = []
    pend1: list[bytes] = []

    def flush():
        nonlocal nid
        for pend, steps in ((pend0, steps0), (pend1, steps1)):
            if pend:
                nid += 1
                g.segments[str(nid)] = b"".join(pend).decode()
                steps.append((str(nid), False))
                pend.clear()

    shared_bp = 0
    for ln, op in zip(lens.tolist(), ops.tolist()):
        if op == cigar_mod.OP_EQ:
            flush()
            nid += 1
            g.segments[str(nid)] = s0[p0 : p0 + ln].decode()
            steps0.append((str(nid), False))
            steps1.append((str(nid), False))
            shared_bp += ln
            p0 += ln
            p1 += ln
        elif op == cigar_mod.OP_X:
            pend0.append(s0[p0 : p0 + ln])
            pend1.append(s1[p1 : p1 + ln])
            p0 += ln
            p1 += ln
        elif op == cigar_mod.OP_I:  # consumes query (s0)
            pend0.append(s0[p0 : p0 + ln])
            p0 += ln
        elif op == cigar_mod.OP_D:  # consumes target (s1)
            pend1.append(s1[p1 : p1 + ln])
            p1 += ln
        else:  # 'M' — treat as aligned columns without match info
            pend0.append(s0[p0 : p0 + ln])
            pend1.append(s1[p1 : p1 + ln])
            p0 += ln
            p1 += ln
    flush()
    if p0 != len(s0) or p1 != len(s1):
        return None  # defensive: runs did not cover the sequences
    g.paths = [("u0", steps0), ("u1", steps1)]
    link_set = set()
    for _, steps in g.paths:
        for a, b in zip(steps, steps[1:]):
            link_set.add((a[0], a[1], b[0], b[1]))
    g.links = sorted(link_set)
    return g, shared_bp


def _block_cost(block: Gfa) -> int:
    return (
        sum(len(s) for s in block.segments.values())
        + _NODE_COST * len(block.segments)
    )


def _affix_block(uniq: list[bytes]) -> Gfa | None:
    """Affix-split candidate: peel the alleles' exact shared prefix/suffix
    into shared nodes and keep each distinct interior as ONE private lane.

    This is the safe resolution for alleles whose interiors have no usable
    forward homology (e.g. phase-shifted repeat insertions, where an
    optimal POA merges coincidental bases into a microtangle — the
    reference testbed's 'POA over-fragments the insertion' failure mode).
    Returns None when there is no shared affix to peel."""
    pre = 0
    lim = min(len(s) for s in uniq)
    while pre < lim and len({s[pre] for s in uniq}) == 1:
        pre += 1
    suf = 0
    while suf < lim - pre and len({s[len(s) - 1 - suf] for s in uniq}) == 1:
        suf += 1
    if pre == 0 and suf == 0:
        return None
    g = Gfa()
    nid = 1
    if pre:
        g.segments[str(nid)] = uniq[0][:pre].decode()
        pre_id = str(nid)
        nid += 1
    if suf:
        g.segments[str(nid)] = uniq[0][len(uniq[0]) - suf :].decode()
        suf_id = str(nid)
        nid += 1
    interior_id: dict[bytes, str] = {}
    paths = []
    for k, s in enumerate(uniq):
        mid = s[pre : len(s) - suf]
        steps = []
        if pre:
            steps.append((pre_id, False))
        if mid:
            if mid not in interior_id:
                g.segments[str(nid)] = mid.decode()
                interior_id[mid] = str(nid)
                nid += 1
            steps.append((interior_id[mid], False))
        if suf:
            steps.append((suf_id, False))
        paths.append((f"u{k}", steps))
    g.paths = paths
    link_set = set()
    for _, steps in paths:
        for a, b in zip(steps, steps[1:]):
            link_set.add((a[0], a[1], b[0], b[1]))
    g.links = sorted(link_set)
    return g


def _realign_region(uniq: list[bytes], scoring, max_span: int,
                    polish: bool, budget: int | None = None
                    ) -> tuple[Gfa, int, bool]:
    """(block graph, cost, polished) for one region's distinct alleles.

    Paths in the returned block are named u0..u{n-1} matching `uniq`
    order.  With `polish`, several POA sequence orderings are tried and
    the cheapest block wins (POA is order-sensitive; the reference's
    polish tier re-solves bounded bubbles with an exact aligner)."""
    names_u = [f"u{k}" for k in range(len(uniq))]
    pair_cand = None
    if len(uniq) == 2 and max(len(s) for s in uniq) <= max_span:
        # Dominant bubble class: one native pairwise alignment builds the
        # block directly (POA graph construction is pure overhead for two
        # sequences; tens of thousands of these per round at C4 scale).
        # Trusted alone only when sharing is near-total (near-identical
        # alleles); otherwise the convex-gap POA below may align better
        # (affine vs two-piece gaps) and the cheaper block wins.
        got = _pair_block(uniq[0], uniq[1])
        if got is not None:
            block, shared_bp = got
            frac = 2.0 * shared_bp / (len(uniq[0]) + len(uniq[1]))
            cost = _block_cost(block)
            if frac >= 0.98 or (budget is not None and cost < budget):
                # Near-identical alleles, or the pair block already WINS
                # the caller's do-no-harm budget: POA could only shave a
                # few more bp — skip it (tens of thousands of these per
                # round at C4 scale).
                return block, cost, False
            if frac < 0.3:
                # Hopeless divergence: the alleles share (almost) nothing
                # forward — POA cannot conjure homology the pairwise
                # aligner missed; settle between pair and affix split.
                affix = _affix_block(uniq)
                if affix is not None:
                    ac = _block_cost(affix)
                    if ac < cost:
                        return affix, ac, False
                return block, cost, False
            pair_cand = block
    if len(uniq) == 1:
        # Pure duplicate redundancy: different node walks, one spelling —
        # the block is a single shared node (the dominant case on real
        # redundant graphs; no POA needed).
        g = Gfa()
        g.segments["1"] = uniq[0].decode()
        g.paths = [("u0", [("1", False)])]
        return g, _block_cost(g), False
    span = max(len(s) for s in uniq)
    if span > max_span:
        block = Gfa.parse(_induce_block(names_u, uniq))
        return block, _block_cost(block), False

    def run(order):
        seqs = [uniq[i] for i in order]
        names = [names_u[i] for i in order]
        result = poa_mod.poa_align(seqs, scoring)
        return poa_mod.poa_to_block(result, names)

    base_order = list(range(len(uniq)))
    block = run(base_order)
    cost = _block_cost(block)
    # Affix-split tier: always a candidate — it wins whenever the POA
    # microtangles interiors with no real forward homology.
    affix = _affix_block(uniq)
    if affix is not None:
        c = _block_cost(affix)
        if c < cost:
            block, cost = affix, c
    if pair_cand is not None:
        c = _block_cost(pair_cand)
        if c < cost:
            block, cost = pair_cand, c
    if not polish or len(uniq) < 3:
        return block, cost, False
    polished = False
    tried = {tuple(base_order)}
    for order in (
        sorted(base_order, key=lambda i: -len(uniq[i])),  # longest first
        base_order[::-1],
    ):
        key = tuple(order)
        if key in tried:
            continue
        tried.add(key)
        cand = run(order)
        c = _block_cost(cand)
        if c < cost:
            block, cost, polished = cand, c, True
    return block, cost, polished


def _realign_many(
    cands: list[tuple[list[bytes], int]], scoring, max_span: int,
    polish: bool,
) -> list[tuple[Gfa, int, bool]]:
    """Realign candidate regions `(uniq, budget)` — index-aligned results.

    Distinct regions are independent and the native POA/pairwise kernels
    are handle-based with no shared state (ctypes releases the GIL during
    the call), so a thread pool scales the round's dominant cost across
    cores — the role of the reference's rayon-parallel per-bubble
    realignment (resolution.rs:997 resolve_gfa_bubbles). Oversized
    regions route to the pairwise-induction tier whose syncmer dictionary
    lazily initializes native lookup tables; those run serially."""
    results: list = [None] * len(cands)
    ser = [
        i for i, (uniq, _old) in enumerate(cands)
        if len(uniq) > 1 and max(len(s) for s in uniq) > max_span
    ]
    ser_set = set(ser)
    par = [i for i in range(len(cands)) if i not in ser_set]

    def work(i: int):
        uniq, old = cands[i]
        return _realign_region(uniq, scoring, max_span, polish, budget=old)

    workers = min(len(par), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(workers) as ex:
            for i, res in zip(par, ex.map(work, par)):
                results[i] = res
    else:
        for i in par:
            results[i] = work(i)
    for i in ser:
        results[i] = work(i)
    return results


def _crush_round(
    gfa: Gfa, stats: CrushStats, scoring, max_span: int, polish: bool,
    rejected: set | None = None,
) -> tuple[Gfa | None, int]:
    """One resolution round over `gfa`. Returns (new graph or None if no
    region was accepted, number of accepted bubbles).

    `rejected` memoizes (alleles, reclaimable-cost, polish) keys whose
    realignment lost the do-no-harm gate: identical inputs produce the
    identical rejection, so convergence/polish rounds skip their POA
    (on redundant 40 MiB graphs this is 2/3 of all realignment calls)."""
    anchors, participating = _find_anchors(gfa)
    if len(gfa.paths) < 2:
        return None, 0
    anchor_set = set(anchors)

    # Region slices per path, bounded by real + virtual anchors:
    # (path_idx, step_lo, step_hi, walk) where steps[lo:hi] is the allele
    # walk. Anchors stay untouched — accepted realignments SPLICE into the
    # standing graph (the reference's path-preserving local resolution).
    region_slices: dict[tuple, list[tuple[int, int, int, tuple]]] = {}
    excluded = 0
    for pi, (name, steps) in enumerate(gfa.paths):
        occ = [k for k, st in enumerate(steps) if st in anchor_set]
        if name in participating and anchors:
            apos = occ  # every anchor exactly once, in order (by contract)
        elif not occ:
            apos = []  # floater: whole walk is one virtual-region allele
        else:
            # Partial/duplicated anchor usage (scrambled / RC walk): leave
            # this path untouched — purely local degradation, its nodes are
            # protected by the reclaim accounting below.
            excluded += 1
            continue
        bounds = (
            [(_VSTART, -1)]
            + [(steps[k], k) for k in apos]
            + [(_VEND, len(steps))]
        )
        for (ta, a), (tb, b) in zip(bounds, bounds[1:]):
            rid = (ta, tb)
            region_slices.setdefault(rid, []).append(
                (pi, a + 1, b, tuple(steps[a + 1 : b]))
            )
    stats.excluded_paths = max(stats.excluded_paths, excluded)

    next_id = 1 + max(
        (int(s) for s in gfa.segments if s.isdigit()), default=0
    )
    # Global per-node step-usage counts: a region may only claim the
    # bp of nodes whose EVERY use lies inside that region's slices —
    # shared nodes survive the splice and reclaim nothing.
    global_use: dict[str, int] = {}
    for _name, steps in gfa.paths:
        for sid, _rev in steps:
            global_use[sid] = global_use.get(sid, 0) + 1
    new_segments: dict[str, str] = {}
    splices: dict[int, list[tuple[int, int, tuple]]] = {}
    n_bubbles = 0
    pending: list = []
    for rid, slices in region_slices.items():
        walks = {w for _, _, _, w in slices}
        # A bubble = the paths take different node walks through the
        # region (identical-sequence walks through duplicated nodes
        # count: that redundancy is exactly what realignment collapses).
        if len(walks) <= 1:
            continue
        stats.bubbles_seen += 1
        walk_seq = {
            w: b"".join(_step_seq(gfa, st) for st in w) for w in walks
        }
        uniq = sorted({s for s in walk_seq.values() if s})
        if not uniq:
            continue  # every allele spells empty; nothing to realign
        # Per-region do-no-harm (the reference validates resolution
        # quality per bubble): accept only when the realignment SHRINKS
        # the region under a combined cost — bp plus a per-node charge,
        # so neither ballooning unrelated alleles into duplicated
        # sequence nor shredding them into confetti nodes can win.
        region_use: dict[str, int] = {}
        for _pi, _lo, _hi, w in slices:
            for sid, _rev in w:
                region_use[sid] = region_use.get(sid, 0) + 1
        reclaimable = {
            sid for sid, c in region_use.items()
            if global_use.get(sid, 0) == c
        }
        old = (
            sum(len(gfa.segments[s]) for s in reclaimable)
            + _NODE_COST * len(reclaimable)
        )
        memo_key = None
        if rejected is not None:
            # Polish only changes the outcome for >=3 alleles; below that
            # a prior unpolished rejection stands (same key).
            eff_polish = polish and len(uniq) >= 3
            memo_key = (hash(tuple(uniq)), old, eff_polish)
            if memo_key in rejected:
                continue
        pending.append((slices, walk_seq, uniq, old, memo_key))

    # Realign gathered candidates in parallel, then apply acceptance in
    # gather order (splice bookkeeping and node naming stay deterministic
    # — identical output to the serial loop).
    realigned = _realign_many(
        [(uniq, old) for _, _, uniq, old, _ in pending],
        scoring, max_span, polish,
    )
    for (slices, walk_seq, uniq, old, memo_key), (
        block, cand, polished,
    ) in zip(pending, realigned):
        if cand >= old:
            if rejected is not None and memo_key is not None:
                rejected.add(memo_key)
            continue
        if polished:
            stats.polish_gains += 1
        rename = {}
        for sid, seq in block.segments.items():
            nid = str(next_id)
            next_id += 1
            rename[sid] = nid
            new_segments[nid] = seq
        walk_of = dict(block.paths)
        seq_new_walk: dict[bytes, tuple] = {b"": ()}
        for k, s in enumerate(uniq):
            seq_new_walk[s] = tuple(
                (rename[sid], rev) for sid, rev in walk_of[f"u{k}"]
            )
        for pi, lo, hi, w in slices:
            splices.setdefault(pi, []).append(
                (lo, hi, seq_new_walk[walk_seq[w]])
            )
        n_bubbles += 1

    if not n_bubbles:
        return None, 0

    # Splice accepted regions back-to-front per path; prune nodes no
    # path uses; regenerate links from path adjacencies (blunt 0M).
    new_paths = []
    for pi, (name, steps) in enumerate(gfa.paths):
        reps = sorted(splices.get(pi, []), reverse=True)
        steps = list(steps)
        for lo, hi, walk in reps:
            steps[lo:hi] = list(walk)
        new_paths.append((name, steps))
    ng = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    used = {sid for _, steps in new_paths for sid, _ in steps}
    merged = {**gfa.segments, **new_segments}
    ng.segments = {
        sid: seq for sid, seq in merged.items() if sid in used
    }
    link_set = set()
    for _, steps in new_paths:
        for a, b in zip(steps, steps[1:]):
            link_set.add((a[0], a[1], b[0], b[1]))
    ng.links = sorted(link_set)
    ng.paths = new_paths
    return ng, n_bubbles


def _find_anchors_columns(gc, keys, po):
    """Columnar mirror of `_find_anchors` over packed step keys
    (name_idx*2 + rev): (anchor keys in first-walk order, participating
    path indices). Same participation and order-violation rules."""
    import numpy as np

    n_paths = gc.n_paths
    once_sets = []
    for p in range(n_paths):
        kp = keys[po[p] : po[p + 1]]
        u, c = np.unique(kp, return_counts=True)
        once_sets.append(u[c == 1])

    k0 = keys[po[0] : po[1]]
    cand = once_sets[0]
    order0 = k0[np.isin(k0, cand)]  # each cand key appears once in k0
    sort_idx = np.argsort(order0, kind="stable")
    sorted_keys = order0[sort_idx]
    participating = [0]
    for p in range(1, n_paths):
        shared = np.intersect1d(once_sets[p], cand, assume_unique=True)
        if not shared.size:
            continue
        kp = keys[po[p] : po[p + 1]]
        vals = kp[np.isin(kp, shared)]
        if not vals.size:
            continue
        seq = sort_idx[np.searchsorted(sorted_keys, vals)]
        inc = int((np.diff(seq) > 0).sum()) if seq.size > 1 else 0
        if seq.size < 2 or inc >= 0.5 * (seq.size - 1):
            participating.append(p)
    canf = once_sets[0]
    for p in participating[1:]:
        canf = np.intersect1d(canf, once_sets[p], assume_unique=True)
    first = k0[np.isin(k0, canf)]
    fsort = np.argsort(first, kind="stable")
    fsorted = first[fsort]
    ok = np.ones(first.size, bool)
    for p in participating[1:]:
        kp = keys[po[p] : po[p + 1]]
        vals = kp[np.isin(kp, fsorted)]
        if not vals.size:
            continue
        s = fsort[np.searchsorted(fsorted, vals)]
        runmax = np.maximum.accumulate(s)
        ok[s[s < runmax]] = False
    return first[ok], participating


def _crush_round_columns(
    gc, stats: CrushStats, scoring, max_span: int, polish: bool,
    rejected: set | None = None, retry_polish: bool = False,
):
    """Columnar `_crush_round`: read passes (anchors, slicing, allele
    grouping/spelling, reclaim accounting) run over GfaColumns arrays;
    realignment and acceptance are shared with the dict round. Returns
    (new GfaColumns or None, accepted bubble count). Semantics match the
    dict round (fuzz-verified: identical stats/spellings; node NAMES may
    number in a different order)."""
    import numpy as np

    from impg_tpu_torch.graph import columnar_ops as co

    if gc.n_paths < 2:
        return None, 0, polish
    po = gc.path_off.astype(np.int64)
    keys = gc.step_name_idx.astype(np.int64) * 2 + gc.step_rev
    anchors, participating = _find_anchors_columns(gc, keys, po)
    part_set = set(participating)
    anchors_sorted = np.sort(anchors)

    # ── slice table (vectorized per path) ────────────────────────────────
    # One row per inter-anchor region slice: path, local [lo, hi) step
    # range, and the bounding (left, right) anchor tokens.  Virtual
    # start/end anchors are the tokens -1 / -2 (real tokens are >= 0).
    sl_p, sl_lo, sl_hi, sl_ra, sl_rb = [], [], [], [], []
    excluded = 0
    for p in range(gc.n_paths):
        kp = keys[po[p] : po[p + 1]]
        occ = np.nonzero(np.isin(kp, anchors_sorted))[0]
        if p in part_set and anchors_sorted.size:
            apos = occ
        elif occ.size == 0:
            apos = occ[:0]
        else:
            excluded += 1
            continue
        bounds = np.concatenate([[-1], apos, [kp.size]])
        toks = np.concatenate([[-1], kp[apos], [-2]])
        sl_p.append(np.full(bounds.size - 1, p, np.int64))
        sl_lo.append(bounds[:-1] + 1)
        sl_hi.append(bounds[1:])
        sl_ra.append(toks[:-1])
        sl_rb.append(toks[1:])
    stats.excluded_paths = max(stats.excluded_paths, excluded)
    if not sl_p:
        return None, 0, polish
    S_p = np.concatenate(sl_p)
    S_lo = np.concatenate(sl_lo).astype(np.int64)
    S_hi = np.concatenate(sl_hi).astype(np.int64)
    G_lo = po[S_p] + S_lo  # global step positions
    G_hi = po[S_p] + S_hi
    S_len = G_hi - G_lo
    tok_base = 2 * len(gc.names) + 2
    rid = (
        (np.concatenate(sl_ra) + 2) * tok_base
        + (np.concatenate(sl_rb) + 2)
    )

    # ── walk grouping by position-in-slice polynomial hash ──────────────
    # h(slice) = sum (key_j + salt) * W^j over the slice's own positions
    # (uint64 wraparound arithmetic), so equal step-key substrings hash
    # equal wherever they sit.  A collision would only merge two walk
    # groups whose spellings then disagree — caught by the round's
    # exact-spelling validation (crush_gfa refuses the round).  The
    # weight table is max-slice-length long, not path-length long.
    n_steps = keys.size
    n_slices = S_p.size
    cum = np.zeros(n_slices + 1, np.int64)
    np.cumsum(S_len, out=cum[1:])
    tot = int(cum[-1])
    pos_in_slice = (
        np.arange(tot, dtype=np.int64) - np.repeat(cum[:-1], S_len)
    )
    step_pos = pos_in_slice + np.repeat(G_lo, S_len)
    with np.errstate(over="ignore"):  # uint64 wraparound IS the modulus
        W = np.uint64(0x9E3779B97F4A7C15 | 1)
        max_len = int(S_len.max()) if n_slices else 0
        wpow = np.empty(max_len + 1, np.uint64)
        wpow[0] = 1
        if max_len:
            np.cumprod(np.full(max_len, W, np.uint64), out=wpow[1:])
        terms = (
            keys.take(step_pos).astype(np.uint64) + np.uint64(0x9E37)
        ) * wpow[pos_in_slice]
        H = np.add.reduceat(
            terms, np.minimum(cum[:-1], max(tot - 1, 0))
        ) if tot else np.zeros(n_slices, np.uint64)
    # reduceat quirk: an empty slice returns the NEXT element, and a
    # trailing empty slice clamps — force empties to 0.
    H[S_len == 0] = 0

    # Sort slices by (region, walk) — stable, so ties keep slice order.
    order = np.lexsort((H, S_len, rid))
    rid_s = rid.take(order)
    H_s = H.take(order)
    L_s = S_len.take(order)
    new_r = np.ones(order.size, bool)
    new_r[1:] = rid_s[1:] != rid_s[:-1]
    new_w = new_r.copy()
    new_w[1:] |= (H_s[1:] != H_s[:-1]) | (L_s[1:] != L_s[:-1])
    reg_sorted = np.cumsum(new_r) - 1  # region ordinal per sorted slice
    wg_sorted = np.cumsum(new_w) - 1  # walk-group ordinal per sorted slice
    n_regions = int(reg_sorted[-1]) + 1
    region_start = np.nonzero(new_r)[0]
    region_end = np.append(region_start[1:], order.size)
    wstart = np.nonzero(new_w)[0]  # sorted position of each group's rep
    walks_per_region = np.bincount(reg_sorted[new_w], minlength=n_regions)
    lo_w = np.searchsorted(wstart, region_start)
    hi_w = np.searchsorted(wstart, region_end)

    names = gc.names
    n_names = len(names)
    global_use = np.bincount(gc.step_name_idx, minlength=n_names)
    rows_of = gc.seg_row_of_name()
    seg_lens = gc.seg_lens()

    # ── reclaim accounting (vectorized over every slice step) ───────────
    # A region may only claim nodes whose EVERY use (across all paths,
    # including excluded ones) lies inside that region's slices.
    # Reuses the hash pass's CSR expansion (cum / step_pos).
    reg_of_slice = np.empty(S_p.size, np.int64)
    reg_of_slice[order] = reg_sorted
    comb = (
        np.repeat(reg_of_slice, S_len) * n_names
        + gc.step_name_idx.take(step_pos)
    )
    uniq_comb, comb_counts = np.unique(comb, return_counts=True)
    r_of = uniq_comb // n_names
    nm_of = uniq_comb % n_names
    recl = comb_counts == global_use[nm_of]
    contrib = np.where(recl, seg_lens[rows_of[nm_of]] + _NODE_COST, 0)
    old_cost = np.bincount(
        r_of, weights=contrib.astype(np.float64), minlength=n_regions
    ).astype(np.int64)

    # Bubble regions (>1 distinct walk), in first-slice-occurrence order
    # (the dict-model insertion order).
    first_idx = np.minimum.reduceat(order, region_start)
    bubble_regions = np.nonzero(walks_per_region > 1)[0]
    bubble_order = bubble_regions[
        np.argsort(first_idx[bubble_regions], kind="stable")
    ]

    # Spell every bubble region's walk representatives in ONE batched
    # native call (full-path spelling is ~1 GB on 100-path graphs; the
    # representatives are kilobytes).
    rep_spellings: list[list[bytes]] = []
    if bubble_order.size:
        rep_pos = np.concatenate(
            [wstart[lo_w[r]:hi_w[r]] for r in bubble_order.tolist()]
        )
        rep_counts = (hi_w - lo_w)[bubble_order]
        rep_si = order[rep_pos]
        rep_glo = G_lo[rep_si]
        rep_nsteps = G_hi[rep_si] - rep_glo
        rtot = int(rep_nsteps.sum())
        rcum = np.zeros(rep_si.size + 1, np.int64)
        np.cumsum(rep_nsteps, out=rcum[1:])
        rsteps = (
            np.arange(rtot, dtype=np.int64)
            - np.repeat(rcum[:-1], rep_nsteps)
            + np.repeat(rep_glo, rep_nsteps)
        )
        rrows = rows_of.take(gc.step_name_idx.take(rsteps)).astype(np.int32)
        rrevs = gc.step_rev.take(rsteps).astype(np.uint8)
        bp_out = np.zeros(rtot + 1, np.int64)
        np.cumsum(seg_lens.take(rrows), out=bp_out[1:])
        from impg_tpu_torch.io import native as native_mod

        blob = native_mod.spell_steps(
            gc.seq_blob, gc.seq_offsets, rrows, rrevs, bp_out, reuse=False
        )
        rep_bp = bp_out[rcum]  # rep boundaries in the blob
        at = 0
        for cnt in rep_counts.tolist():
            rep_spellings.append([
                blob[int(rep_bp[at + i]):int(rep_bp[at + i + 1])].tobytes()
                for i in range(cnt)
            ])
            at += cnt

    next_id0 = 1 + max(
        (int(names[int(i)]) for i in gc.seg_name_idx
         if names[int(i)].isdigit()),
        default=0,
    )
    new_name_base = n_names

    def gather(pol: bool) -> list:
        pend: list = []
        for bi, r in enumerate(bubble_order.tolist()):
            stats.bubbles_seen += 1
            rep_spell = rep_spellings[bi]
            uniq = sorted({s for s in rep_spell if s})
            if not uniq:
                continue
            old = int(old_cost[r])
            memo_key = None
            if rejected is not None:
                eff_polish = pol and len(uniq) >= 3
                memo_key = (hash(tuple(uniq)), old, eff_polish)
                if memo_key in rejected:
                    continue
            pend.append((r, rep_spell, uniq, old, memo_key))
        return pend

    # Attempt the round; when nothing is accepted and `retry_polish` is
    # set, rerun realignment with polish=True ON THE SAME DISCOVERY —
    # the graph is unchanged by definition, so re-deriving slice tables,
    # walk groups and reclaim costs from text (the expensive half of a
    # round at 60 MiB scale) would reproduce exactly this state.  This
    # mirrors the dict protocol's separate polish round (including the
    # per-round bubbles_seen accounting).
    attempts = [polish]
    if retry_polish and not polish:
        attempts.append(True)
    used_polish = polish
    n_bubbles = 0
    for pol in attempts:
        pending = gather(pol)
        # Parallel realignment (see _realign_many); acceptance / splice /
        # naming applied serially in gather order so the output is
        # identical to the serial loop.
        realigned = _realign_many(
            [(uniq, old) for _, _, uniq, old, _ in pending],
            scoring, max_span, pol,
        )
        # Accepted splices accumulate as plain lists (one numpy op per
        # region measurably dominates rounds with tens of thousands of
        # accepts); everything flattens into arrays once, below.
        next_id = next_id0
        new_segments: list[tuple[str, bytes]] = []
        acc_regions: list[int] = []
        acc_glens: list[int] = []  # walk len per (region, walk group)
        acc_gcnt: list[int] = []  # walk-group count per accepted region
        W_parts: list[np.ndarray] = []
        n_bubbles = 0
        for (r, rep_spell, uniq, old, memo_key), (
            block, cand, polished,
        ) in zip(pending, realigned):
            if cand >= old:
                if rejected is not None and memo_key is not None:
                    rejected.add(memo_key)
                continue
            if polished:
                stats.polish_gains += 1
            rename: dict[str, int] = {}
            for sid, seq in block.segments.items():
                rename[sid] = new_name_base + len(new_segments)
                new_segments.append((str(next_id), seq.encode()))
                next_id += 1
            walk_of = dict(block.paths)
            seq_new_walk: dict[bytes, np.ndarray] = {
                b"": np.zeros(0, np.int64)
            }
            for k, s in enumerate(uniq):
                seq_new_walk[s] = np.asarray(
                    [rename[sid] * 2 + rev
                     for sid, rev in walk_of[f"u{k}"]],
                    np.int64,
                )
            walk_arrays = [seq_new_walk[s] for s in rep_spell]
            W_parts.extend(walk_arrays)
            acc_regions.append(int(r))
            acc_glens.extend(w.size for w in walk_arrays)
            acc_gcnt.append(len(walk_arrays))
            n_bubbles += 1
        used_polish = pol
        if n_bubbles:
            break

    if not n_bubbles:
        return None, 0, used_polish

    # Flatten accepted regions -> per-slice replacement table.
    acc_r = np.asarray(acc_regions, np.int64)
    gl_flat = np.asarray(acc_glens, np.int64)
    g_off_flat = np.zeros(gl_flat.size + 1, np.int64)
    np.cumsum(gl_flat, out=g_off_flat[1:])
    gcnt = np.asarray(acc_gcnt, np.int64)
    ggroup_base = np.zeros(acc_r.size, np.int64)
    if acc_r.size > 1:
        np.cumsum(gcnt[:-1], out=ggroup_base[1:])
    reg_sizes = (region_end - region_start)[acc_r]
    rtot2 = int(reg_sizes.sum())
    rcum2 = np.zeros(acc_r.size + 1, np.int64)
    np.cumsum(reg_sizes, out=rcum2[1:])
    pos_all = (
        np.arange(rtot2, dtype=np.int64)
        - np.repeat(rcum2[:-1], reg_sizes)
        + np.repeat(region_start[acc_r], reg_sizes)
    )
    ggi = (
        np.repeat(ggroup_base, reg_sizes)
        + wg_sorted.take(pos_all)
        - np.repeat(wg_sorted[region_start[acc_r]], reg_sizes)
    )
    acc_si = [order.take(pos_all)]
    acc_wlen = [gl_flat[ggi]]
    acc_woff = [g_off_flat[:-1][ggi]]

    # ── assemble the new step stream (all splices at once) ──────────────
    # Delete each spliced slice's [G_lo, G_hi) step range (difference-
    # array mask) and insert its replacement walk at G_lo; kept steps and
    # inserted walks interleave by global position, so output indices are
    # rank sums — no per-path piece concatenation.
    all_names = list(names) + [n for n, _ in new_segments]
    spl_si = np.concatenate(acc_si)
    spl_wlen = np.concatenate(acc_wlen)
    spl_woff = np.concatenate(acc_woff)
    W_all = (
        np.concatenate(W_parts) if W_parts else np.zeros(0, np.int64)
    )
    spl_glo = G_lo.take(spl_si)
    spl_ghi = G_hi.take(spl_si)
    spl_path = S_p.take(spl_si)
    mark = np.zeros(n_steps + 1, np.int64)
    np.add.at(mark, spl_glo, 1)
    np.add.at(mark, spl_ghi, -1)
    kept_pos = np.nonzero(np.cumsum(mark[:-1]) == 0)[0]
    s_ord = np.argsort(spl_glo, kind="stable")
    spl_glo = spl_glo[s_ord]
    spl_wlen = spl_wlen[s_ord]
    spl_woff = spl_woff[s_ord]
    spl_path = spl_path[s_ord]
    ins_cum = np.zeros(spl_glo.size + 1, np.int64)
    np.cumsum(spl_wlen, out=ins_cum[1:])
    total_ins = int(ins_cum[-1])
    out_kept = (
        np.arange(kept_pos.size, dtype=np.int64)
        + ins_cum[np.searchsorted(spl_glo, kept_pos, side="right")]
    )
    ins_start = (
        np.searchsorted(kept_pos, spl_glo, side="left") + ins_cum[:-1]
    )
    nk = np.empty(kept_pos.size + total_ins, np.int64)
    nk[out_kept] = keys.take(kept_pos)
    if total_ins:
        ramp = np.arange(total_ins, dtype=np.int64) - np.repeat(
            ins_cum[:-1], spl_wlen
        )
        nk[np.repeat(ins_start, spl_wlen) + ramp] = W_all[
            np.repeat(spl_woff, spl_wlen) + ramp
        ]
    kept_per_path = np.diff(np.searchsorted(kept_pos, po))
    ins_per_path = np.bincount(
        spl_path, weights=spl_wlen.astype(np.float64),
        minlength=gc.n_paths,
    ).astype(np.int64)
    new_path_off = np.zeros(gc.n_paths + 1, np.int64)
    np.cumsum(kept_per_path + ins_per_path, out=new_path_off[1:])
    step_name_idx = (nk >> 1).astype(np.int32)
    step_rev = (nk & 1).astype(bool)

    used = np.unique(step_name_idx) if nk.size else np.zeros(0, np.int64)
    used_set = set(int(u) for u in used)
    # Old segments in original row order, then new ones (dict-merge order).
    keep_rows = [
        r for r in range(gc.n_segs)
        if int(gc.seg_name_idx[r]) in used_set
    ]
    new_keep = [
        j for j, _ in enumerate(new_segments)
        if (new_name_base + j) in used_set
    ]
    from impg_tpu_torch.io import native as native_mod

    order = np.asarray(keep_rows, np.int32)
    lens_keep = seg_lens[order] if order.size else np.zeros(0, np.int64)
    off_keep = np.concatenate([[0], np.cumsum(lens_keep)]).astype(np.int64)
    old_blob = native_mod.spell_steps(
        gc.seq_blob, gc.seq_offsets, order,
        np.zeros(order.size, np.uint8), off_keep, reuse=False,
    )
    new_blob = b"".join(new_segments[j][1] for j in new_keep)
    blob = old_blob.tobytes() + new_blob
    seg_name_idx = np.asarray(
        [int(gc.seg_name_idx[r]) for r in keep_rows]
        + [new_name_base + j for j in new_keep],
        np.int32,
    )
    seq_offsets = np.concatenate([
        off_keep,
        int(off_keep[-1]) + np.cumsum(
            np.asarray([len(new_segments[j][1]) for j in new_keep],
                       np.int64)
        ),
    ]).astype(np.int64) if new_keep else off_keep

    from dataclasses import replace

    ng = replace(
        gc,
        names=all_names,
        seg_name_idx=seg_name_idx,
        seq_blob=blob,
        seq_offsets=seq_offsets,
        link_a=np.zeros(0, np.int32),
        link_a_rev=np.zeros(0, bool),
        link_b=np.zeros(0, np.int32),
        link_b_rev=np.zeros(0, bool),
        path_off=np.asarray(new_path_off, np.int64),
        step_name_idx=step_name_idx,
        step_rev=step_rev,
        _seg_row_of_name=None,
    )
    packed = co.links_from_paths(ng)  # uint64-packed, logical shifts
    ng.link_a = (packed >> np.uint64(33)).astype(np.int32)
    ng.link_a_rev = ((packed >> np.uint64(32)) & np.uint64(1)).astype(bool)
    ng.link_b = (
        (packed >> np.uint64(1)) & np.uint64((1 << 31) - 1)
    ).astype(np.int32)
    ng.link_b_rev = (packed & np.uint64(1)).astype(bool)
    return ng, n_bubbles, used_polish


def crush_gfa(
    gfa_text: str,
    max_span: int = 10_000,
    max_rounds: int = 4,
    scoring=poa_mod.DEFAULT_SCORING,
    polish: bool = True,
) -> tuple[str, CrushStats]:
    stats = CrushStats()
    # Pre-groom (spelling-preserving majority-orientation flips): paths
    # that traverse the shared backbone reverse-complemented become
    # forward walks, so they can participate in anchor slicing instead of
    # being excluded from their regions.  Columnar fast path (the dict
    # parse+groom+write round-trip costs ~20 s on 60 MiB graphs); dict
    # model handles degenerate duplicate-S inputs and the no-native case.
    from impg_tpu_torch.graph import columnar_ops

    import numpy as np

    gc0 = None
    try:
        from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns as _pgc

        gc0 = _pgc(gfa_text)
    except ValueError:
        raise
    except Exception:
        gc0 = None
    if gc0 is not None and (
        gc0.n_segs == 0
        or int(np.unique(gc0.seg_name_idx).size) == gc0.n_segs
    ):
        stats.nodes_before = gc0.n_segs
        stats.bp_before = int(gc0.seg_lens().sum())
        gfa_text = columnar_ops.write_columns(
            columnar_ops.groom_columns(gc0)
        )
    else:
        from impg_tpu_torch.graph.sortgfa import groom

        g0 = Gfa.parse(gfa_text)
        stats.nodes_before = len(g0.segments)
        stats.bp_before = sum(len(s) for s in g0.segments.values())
        gfa_text = groom(g0).write()

    def spell_all(g: Gfa):
        return {
            name: b"".join(_step_seq(g, st) for st in steps)
            for name, steps in g.paths
        }

    before_spell = columnar_ops.path_spellings_of_text(gfa_text)
    if before_spell is None:
        before_spell = spell_all(g0)
    text = gfa_text

    def round_valid(ng: Gfa, new_text: str) -> bool:
        # Exact path validation (the reference's contract). The columnar
        # validator (native spell kernel over the written text) replaces
        # the per-step dict-model join — the round's hottest pass on
        # 50 MiB-class graphs (graph/columnar_ops.py).
        from impg_tpu_torch.graph import columnar_ops

        ok = columnar_ops.validate_text_spellings(new_text, before_spell)
        if ok is None:
            return spell_all(ng) == before_spell
        return ok

    do_polish = False  # main rounds first; polish after convergence
    rounds_left = max_rounds
    rejected: set = set()
    while rounds_left > 0:
        # Columnar round (native tokenizer + spell kernels); dict round
        # is the semantics oracle and fallback.
        gc = None
        try:
            from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

            gc = parse_gfa_columns(text)
        except ValueError:
            raise
        except Exception:
            gc = None
        if gc is not None:
            # retry_polish: a zero-accept round retries with polish on
            # the SAME in-memory discovery instead of re-deriving it
            # from text next iteration (same protocol, same counting).
            ng_c, n_bubbles, used_polish = _crush_round_columns(
                gc, stats, scoring, max_span, do_polish, rejected,
                retry_polish=polish,
            )
            if used_polish:
                do_polish = True
            if ng_c is None:
                if polish and not do_polish:
                    do_polish = True
                    continue
                break
            if not columnar_ops.validate_spellings(ng_c, before_spell):
                break
            new_text = columnar_ops.write_columns(ng_c)
        else:
            gfa = Gfa.parse(text)
            ng, n_bubbles = _crush_round(
                gfa, stats, scoring, max_span, do_polish, rejected
            )
            if ng is None:
                if polish and not do_polish:
                    # Converged: one extra pass retrying POA orderings on
                    # the remaining candidate regions (the polish tier).
                    do_polish = True
                    continue
                break
            new_text = ng.write()
            # Refuse an invalid round and keep the previous text.
            if not round_valid(ng, new_text):
                break
        if new_text == text:
            if polish and not do_polish:
                do_polish = True
                continue
            break
        stats.rounds += 1
        stats.bubbles_resolved += n_bubbles
        text = new_text
        rounds_left -= 1

    gcf = None
    try:
        gcf = _pgc(text) if gc0 is not None else None
    except Exception:
        gcf = None
    if gcf is not None and (
        gcf.n_segs == 0
        or int(np.unique(gcf.seg_name_idx).size) == gcf.n_segs
    ):
        stats.nodes_after = gcf.n_segs
        stats.bp_after = int(gcf.seg_lens().sum())
    else:
        final = Gfa.parse(text)
        stats.nodes_after = len(final.segments)
        stats.bp_after = sum(len(s) for s in final.segments.values())
    return text, stats
