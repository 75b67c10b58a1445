"""Flubble (variation-site) decomposition along a reference path
(reference: graph_report.rs:2130 povu_architecture / povu crate
decompose_flubbles — nested variation sites with level/leaf structure,
reference step spans, and boundary tokens).

TPU-repo equivalent built from path walks rather than biedged cycle
equivalence: a site is bounded by two *anchors* — oriented steps that every
path through the enclosing region visits exactly once, in consistent order
(a deletion allele still passes both boundaries, so reconvergence is
captured).  Anchor decomposition recurses into each variable site on the
paths' slices, yielding the nested site tree.

The port's copy of impg_tpu/graph/bubbles.py, for smooth's
`block-source=flubble` (tests/test_torch_graph_pipeline.py holds the
decomposition equal); `graph-report` and `gfa2vcf --sites flubbles`, its
other callers in impg_tpu, are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from impg_tpu_torch.graph.gfa import Gfa


@dataclass
class Site:
    id: str
    parent_id: str | None
    level: int
    is_leaf: bool
    start: str  # boundary token, e.g. "12+"
    end: str
    # Step index in the reference path walk; -1 when the site lies on a
    # branch the reference walk never takes (nested alternate alleles).
    reference_start_step: int
    reference_end_step: int
    n_alleles: int  # distinct interior walks among the paths through it
    # Site class (POVU flubble class role): "parallel" (same-orientation
    # alternatives), "inversion" (an allele traverses reference-interior
    # nodes flipped), "hairpin" (an allele folds back through the same
    # node in both orientations).
    site_class: str = "parallel"

    @property
    def reference_span_steps(self) -> int:
        return max(self.reference_end_step - self.reference_start_step, 0)


@dataclass
class Decomposition:
    reference_path: str
    sites: list[Site] = field(default_factory=list)

    @property
    def leaf_sites(self) -> int:
        return sum(1 for s in self.sites if s.is_leaf)

    def level_counts(self) -> dict[int, int]:
        out: dict[int, int] = {}
        for s in self.sites:
            out[s.level] = out.get(s.level, 0) + 1
        return dict(sorted(out.items()))


def _token(step) -> str:
    return f"{step[0]}{'-' if step[1] else '+'}"


def _anchors(walks: list[list]) -> list:
    """Oriented steps every walk contains exactly once, in the order of the
    first walk, discarding order violators (crush's anchor rule)."""
    if not walks:
        return []
    per_once = []
    for steps in walks:
        seen: dict = {}
        for st in steps:
            seen[st] = seen.get(st, 0) + 1
        per_once.append({st for st, c in seen.items() if c == 1})
    candidate = set(per_once[0])
    for s in per_once[1:]:
        candidate &= s
    first = [st for st in walks[0] if st in candidate]
    index0 = {st: i for i, st in enumerate(first)}
    ok = set(first)
    for steps in walks[1:]:
        last = -1
        for st in steps:
            if st not in index0:
                continue
            if index0[st] < last:
                ok.discard(st)
            else:
                last = index0[st]
    return [st for st in first if st in ok]


def _decompose_level(
    walks: list[list],
    ref_walk: list | None,
    ref_offset: int,
    level: int,
    parent_id: str | None,
    sites: list[Site],
    counter: list[int],
    max_depth: int = 16,
) -> None:
    """Find sites among `walks` (all sharing the same boundary context);
    recurse into each variable site's interior slices.

    `ref_walk` is the true reference lineage's walk through this region
    (== walks[0]) or None when the region lies on a branch the reference
    never takes — then reference step coordinates are emitted as -1
    instead of fabricating indices into a walk that skips the region."""
    anchors = _anchors(walks)
    if len(anchors) < 2 or level >= max_depth:
        return
    anchor_set = set(anchors)
    on_ref = ref_walk is not None
    # Slice every walk between consecutive anchors (anchor-exclusive
    # interiors; anchors appear in walk order = anchors order by
    # construction).
    per_walk_slices: list[list[list]] = []
    for steps in walks:
        slices: list[list] = []
        cur: list | None = None
        for st in steps:
            if st in anchor_set:
                if cur is not None:
                    slices.append(cur)
                cur = []
            elif cur is not None:
                cur.append(st)
        per_walk_slices.append(slices)
    # Reference step positions of each anchor (anchors are visited by
    # every walk, so when on_ref each anchor is on the reference walk).
    ref_pos = (
        {st: i for i, st in enumerate(ref_walk) if st in anchor_set}
        if on_ref else {}
    )
    for ai in range(len(anchors) - 1):
        interiors = [
            (wi, s[ai]) for wi, s in enumerate(per_walk_slices)
            if ai < len(s)
        ]
        distinct = {tuple(w) for _wi, w in interiors}
        if len(distinct) <= 1:
            continue  # all paths agree: not a variation site
        counter[0] += 1
        sid = f"SB{counter[0]}"
        a, b = anchors[ai], anchors[ai + 1]
        if on_ref:
            rs = ref_offset + ref_pos[a]
            re_ = ref_offset + ref_pos[b]
        else:
            rs = re_ = -1
        site = Site(
            id=sid,
            parent_id=parent_id,
            level=level,
            is_leaf=True,
            start=_token(a),
            end=_token(b),
            reference_start_step=rs,
            reference_end_step=re_,
            n_alleles=len(distinct),
            site_class=_classify_site([w for _wi, w in interiors], a, b),
        )
        sites.append(site)
        # Recurse into the interiors.  Alleles that skip the interior
        # entirely (deletions) or enter/leave through different nodes would
        # poison the shared-anchor set, so group traversing walks by their
        # (first, last) interior steps and nest within each group.
        groups: dict[tuple, list[list]] = {}
        for wi, w in interiors:
            if w:
                groups.setdefault((w[0], w[-1]), []).append(w)
        ref_slice = next(
            (w for wi, w in interiors if wi == 0), None
        ) if on_ref else None
        before = len(sites)
        for key, inner in groups.items():
            if len(inner) < 2 or len({tuple(w) for w in inner}) < 2:
                continue
            if ref_slice and (ref_slice[0], ref_slice[-1]) == key:
                # The reference traverses this group: keep it as walks[0]
                # and carry the true step offset of its first interior
                # step (the step after anchor `a`).
                inner = sorted(inner, key=lambda w: w != ref_slice)
                new_ref: list | None = inner[0]
                new_off = rs + 1
            else:
                new_ref, new_off = None, 0
            _decompose_level(
                inner,
                new_ref,
                new_off,
                level + 1,
                sid,
                sites,
                counter,
                max_depth,
            )
        if len(sites) > before:
            site.is_leaf = False


def _classify_site(interiors: list[list], a, b) -> str:
    """POVU flubble class role: hairpin > inversion > parallel.

    Hairpin: an allele folds back through a node in both orientations —
    inside the interior or back through a boundary anchor reversed.
    Inversion: an allele traverses reference-interior nodes flipped."""
    ref_orient: dict[str, bool] = {}
    for sid_, rev_ in interiors[0] if interiors else []:
        ref_orient.setdefault(sid_, rev_)
    boundary = {a[0]: a[1], b[0]: b[1]}
    cls = "parallel"
    for w in interiors:
        seen: dict[str, bool] = {}
        for sid_, rev_ in w:
            if sid_ in seen and seen[sid_] != rev_:
                return "hairpin"
            if sid_ in boundary and boundary[sid_] != rev_:
                return "hairpin"
            seen.setdefault(sid_, rev_)
            if sid_ in ref_orient and ref_orient[sid_] != rev_:
                cls = "inversion"
    return cls


def decompose_flubbles(
    gfa_text: str, reference_names: list[str] | None = None
) -> Decomposition:
    """Site tree along a reference path (graph_report.rs povu_architecture
    contract: sites with id/parent/level/is_leaf, boundary tokens, reference
    step spans)."""
    gfa = Gfa.parse(gfa_text)
    if not gfa.paths:
        return Decomposition(reference_path="")
    ref_idx = 0
    if reference_names:
        ref_idx = -1
        for i, (name, _) in enumerate(gfa.paths):
            if any(
                name == rn or name.startswith(rn + ":")
                or name.startswith(rn + "#")
                for rn in reference_names
            ):
                ref_idx = i
                break
        if ref_idx < 0:
            have = ", ".join(n for n, _ in gfa.paths[:5])
            raise ValueError(
                f"reference path(s) {reference_names} not found in GFA "
                f"(paths: {have}{', ...' if len(gfa.paths) > 5 else ''})"
            )
    ref_name, ref_walk = gfa.paths[ref_idx]
    # Only paths in the reference's connected component (shared node ids,
    # transitively) take part: a path disjoint from the reference (another
    # chromosome in the same file) shares no steps, so it would empty the
    # global exactly-once anchor intersection and wipe out every site.
    node_sets = [
        {sid for sid, _rev in steps} for _name, steps in gfa.paths
    ]
    in_comp = {ref_idx}
    comp_nodes = set(node_sets[ref_idx])
    changed = True
    while changed:
        changed = False
        for i, ns in enumerate(node_sets):
            if i not in in_comp and ns & comp_nodes:
                in_comp.add(i)
                comp_nodes |= ns
                changed = True
    # Reference walk first: anchor order and interior slice [0] are then
    # reference-anchored at every nesting level.
    order = [ref_idx] + sorted(i for i in in_comp if i != ref_idx)
    walks = [list(gfa.paths[i][1]) for i in order]
    sites: list[Site] = []
    _decompose_level(
        walks, list(ref_walk), 0, 0, None, sites, counter=[0]
    )
    return Decomposition(reference_path=ref_name, sites=sites)


def architecture_text(
    dec: Decomposition, top_n: int = 5
) -> str:
    """Human-readable summary lines (graph_report.rs:558 format role)."""
    lines = [
        f"- Flubble decomposition on reference `{dec.reference_path}`: "
        f"{len(dec.sites)} sites, {dec.leaf_sites} leaves"
    ]
    lc = dec.level_counts()
    if lc:
        lines.append(
            "- Sites per nesting level: "
            + ", ".join(f"L{k}: {v}" for k, v in lc.items())
        )
    top = sorted(
        dec.sites,
        key=lambda s: (-s.reference_span_steps, s.reference_start_step),
    )[:top_n]
    for s in top:
        lines.append(
            f"  - {s.id} (level {s.level}"
            f"{', leaf' if s.is_leaf else ''}, {s.site_class}): "
            f"{s.start} .. {s.end}, "
            f"ref steps {s.reference_start_step}-{s.reference_end_step}, "
            f"{s.n_alleles} alleles"
        )
    return "\n".join(lines)
