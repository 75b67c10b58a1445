"""Graph smoothing: per-block POA realignment (reference: smooth.rs:207
smooth_gfa, the smoothxg-style pipeline).

Pipeline (smooth.rs semantics, simplified block source):
  1. 1D order: stable topological ranks over the segment DAG;
  2. block decomposition: consecutive-rank node groups bounded by a target
     block length in bp;
  3. per block: every path's maximal subwalks through the block spell
     sequences (with their bp offsets along the path);
  4. each block realigns with the native POA engine into a clean local
     graph whose paths are named `path:start-end`;
  5. the block graphs LACE back together (graph/lace.py) into the smoothed
     whole — trimming, linking, renumbering.

Invariant (tested): every path of the smoothed graph spells exactly the same
bases as in the input graph.

Deliberate differences from smooth.rs (SmoothConfig:20-46):
  * no POA edge padding (poa_padding_fraction /
    max_block_depth_for_padding_more): padding overlaps blocks and
    requires trimming pad bases out of the realigned block paths, which
    would forfeit this module's exact-spelling invariant; block
    boundaries here instead respect flubble sites (block_source=
    "flubble"), which addresses the same edge-artifact concern
    structurally.
  * no NeighborMergePoasta third block source (a POASTA-specific
    variant; the two shipped sources cover smoothxg's semantics).

The port's copy of impg_tpu/graph/smooth.py (tests/test_torch_graph_pipeline.py
holds the two equal, fixed and flubble block sources): block POA through the
port's native engine on a thread pool, results applied in block order.
"""

from __future__ import annotations

from impg_tpu_torch.graph import lace as lace_mod
from impg_tpu_torch.graph import poa as poa_mod
from impg_tpu_torch.graph.gfa import Gfa, topological_sort
from impg_tpu_torch.io.fasta import reverse_complement


def _step_seq(gfa: Gfa, step: tuple[str, bool]) -> bytes:
    seq = gfa.segments[step[0]].encode()
    return reverse_complement(seq) if step[1] else seq


def _node_sites(gfa: Gfa, gfa_text: str) -> dict[str, int]:
    """Top-level flubble site id per node (nodes outside any site: -1) —
    the POVU-flubble block source (smooth.rs block_source role): block
    boundaries must not split a variation site."""
    from impg_tpu_torch.graph import bubbles as bubbles_mod

    dec = bubbles_mod.decompose_flubbles(gfa_text)
    site_of: dict[str, set[int]] = {}
    top = [s for s in dec.sites if s.level == 0]
    bounds = {
        (s.start[:-1], s.end[:-1]): i for i, s in enumerate(top)
    }
    # Start-node -> site, computed once (not a per-step linear scan).
    starts = {s.start[:-1]: i for i, s in enumerate(top)}
    for _, steps in gfa.paths:
        active: int | None = None
        for sid, _ in steps:
            started = starts.get(sid)
            if active is not None:
                # Boundary anchors belong to BOTH adjacent sites: a block
                # boundary between a shared anchor and either site's
                # interior would split a variation site.
                site_of.setdefault(sid, set()).add(active)
                end_sid = top[active].end[:-1]
                if sid == end_sid:
                    active = None
            if started is not None:
                site_of.setdefault(sid, set()).add(started)
                active = started
    return site_of


def smooth_gfa(
    gfa_text: str,
    block_len: int = 1100,
    scoring=poa_mod.DEFAULT_SCORING,
    block_source: str = "fixed",
    n_haps: int | None = None,
    max_node_length: int = 0,
) -> str:
    gfa = Gfa.parse(gfa_text)
    if max_node_length > 0:
        # Chop long nodes first so block boundaries can land anywhere
        # (smooth.rs:332 chop_graph, default 100 bp).
        from impg_tpu_torch.graph.gfa import chop_gfa

        gfa = chop_gfa(gfa, max_node_length)
    gfa = topological_sort(gfa)
    if not gfa.paths or not gfa.segments:
        return gfa.write()

    # Block id per node: consecutive ranks, bounded by the block WEIGHT
    # budget block_len * n_haps, where a node's weight is its bp times its
    # path-step depth (smooth.rs:305 max_block_weight = target * n_haps) —
    # deep regions get proportionally shorter blocks so every POA sees a
    # bounded amount of sequence.  With the flubble source, a block never
    # ends inside a variation site — POA always sees whole bubbles.
    if n_haps is None:
        n_haps = max(len(gfa.paths), 1)
    max_block_weight = block_len * max(n_haps, 1)
    depth: dict[str, int] = {sid: 0 for sid in gfa.segments}
    for _name, steps in gfa.paths:
        for sid, _rev in steps:
            depth[sid] += 1
    site_of = (
        _node_sites(gfa, gfa.write()) if block_source == "flubble" else {}
    )
    block_of: dict[str, int] = {}
    cur_block = 0
    cur_w = 0
    prev_sites: set[int] = set()
    for sid in gfa.segments:
        node_w = len(gfa.segments[sid]) * max(depth[sid], 1)
        sites = site_of.get(sid, set())
        # Consecutive nodes sharing ANY site must stay in one block (a
        # shared boundary anchor belongs to both adjacent sites).
        same_site = bool(sites & prev_sites)
        if cur_w > 0 and cur_w + node_w > max_block_weight and not same_site:
            cur_block += 1
            cur_w = 0
        block_of[sid] = cur_block
        cur_w += node_w
        prev_sites = sites
    n_blocks = cur_block + 1

    # Per block: list of (path_name, start_bp, sequence bytes).
    block_slices: dict[int, list[tuple[str, int, bytes]]] = {
        b: [] for b in range(n_blocks)
    }
    for path_name, steps in gfa.paths:
        pos = 0
        run_block = None
        run_start = 0
        run_seq: list[bytes] = []
        for step in steps:
            b = block_of[step[0]]
            piece = _step_seq(gfa, step)
            if run_block is None or b != run_block:
                if run_block is not None and run_seq:
                    block_slices[run_block].append(
                        (path_name, run_start, b"".join(run_seq))
                    )
                run_block = b
                run_start = pos
                run_seq = []
            run_seq.append(piece)
            pos += len(piece)
        if run_block is not None and run_seq:
            block_slices[run_block].append(
                (path_name, run_start, b"".join(run_seq))
            )

    # Strip any existing :start-end suffix so lace keys stay collision-free,
    # rebasing offsets into source coordinates when present.
    def base_key(path_name: str) -> tuple[str, int]:
        base, sep, rng = path_name.rpartition(":")
        if sep and "-" in rng:
            s, _, _ = rng.partition("-")
            try:
                return base, int(s)
            except ValueError:
                pass
        return path_name, 0

    # Per-block POA on a thread pool: blocks are independent and the
    # native POA engine is handle-based with no shared state (ctypes
    # releases the GIL) — the role of smoothxg's block-parallel POA
    # (smooth.rs runs blocks under rayon).  Results apply in block
    # order, so the output is identical to the serial loop.
    import os
    from concurrent.futures import ThreadPoolExecutor

    work = [
        (b, block_slices[b]) for b in range(n_blocks) if block_slices[b]
    ]

    def align_block(slices):
        return poa_mod.poa_align([s for _, _, s in slices], scoring)

    workers = min(len(work), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(workers) as ex:
            results = list(ex.map(lambda w: align_block(w[1]), work))
    else:
        results = [align_block(slices) for _, slices in work]

    block_gfas: list[str] = []
    for (_b, slices), result in zip(work, results):
        names = []
        for path_name, start, seq in slices:
            key, base_off = base_key(path_name)
            lo = base_off + start
            names.append(f"{key}:{lo}-{lo + len(seq)}")
        block_gfas.append(poa_mod.poa_to_gfa(result, names))

    return lace_mod.lace_gfas(block_gfas)


def smooth_gfa_passes(
    gfa_text: str,
    target_poa_lengths=(700, 1100),
    scoring=poa_mod.DEFAULT_SCORING,
    block_source: str = "fixed",
    n_haps: int | None = None,
    max_node_length: int = 100,
) -> str:
    """Multi-pass smoothing (smooth.rs SmoothConfig.target_poa_lengths,
    pggb's `-G 700,1100` default): each pass re-decomposes with its target
    length and feeds the next."""
    text = gfa_text
    for i, target in enumerate(target_poa_lengths):
        text = smooth_gfa(
            text, int(target), scoring,
            block_source=block_source,
            n_haps=n_haps,
            # Chop only on the first pass; later passes inherit the
            # granularity of the previous lace.
            max_node_length=max_node_length if i == 0 else 0,
        )
    return text
