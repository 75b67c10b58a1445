"""Seqwish-style variation-graph induction from alignments.

Functional equivalent of the reference's in-process seqwish engine
(commands/graph.rs:156 build_graph -> seqwish transitive closure): the '='
matches of a PAF alignment set define an equivalence relation over sequence
bases; its transitive closure yields graph nodes, and the original sequences
walk the graph as paths.

Implementation: an orientation-aware (bidirected) union-find over the global
base coordinate space — parent + parity (relative orientation to the root).
Matches union base pairs (with flipped parity for '-' strand rows); nodes
are the equivalence classes; unbranched class chains are compacted into
unchopped segments exactly like the POA GFA writer.

This is the exact semantics of seqwish at base granularity; the reference
uses interval trees + batched transitive closure to scale the same relation
(seqwish paper).

The port's copy of impg_tpu/graph/seqwish.py (tests/test_torch_seqwish.py
holds the two equal, native and Python emit).  The union-find and the emit
run in the port's builds of native/seqwish_uf.cpp and seqwish_emit.cpp
(io/native.py declares their signatures); without that library the
pure-Python union-find and emitter below give the same text.
"""

from __future__ import annotations

import numpy as np

from impg_tpu_torch.core import cigar

# Full IUPAC complement (io/fasta._COMPLEMENT semantics: unmapped bytes
# pass through) — ambiguity codes must survive reverse-oriented spelling.
_COMP = {
    a: b
    for a, b in zip(
        b"ACGTUNRYSWKMBDHVacgtunryswkmbdhv",
        b"TGCAANYRSWMKVHDBtgcaanyrswmkvhdb",
    )
}

class _BidirectedUF:
    """Union-find with parity: find returns (root, orientation-to-root)."""

    def __init__(self, n: int) -> None:
        self.parent = np.arange(n, dtype=np.int64)
        self.parity = np.zeros(n, dtype=np.uint8)
        self.rank = np.zeros(n, dtype=np.int8)

    def find_oriented(self, x: int) -> tuple[int, int]:
        """(root, parity-to-root) with path compression."""
        p = self.parent
        path = [x]
        while p[path[-1]] != path[-1]:
            path.append(p[path[-1]])
        root = path[-1]
        # parity(path[i] -> root) accumulated from the tail inward.
        to_root = [0] * len(path)
        for i in range(len(path) - 2, -1, -1):
            to_root[i] = to_root[i + 1] ^ self.parity[path[i]]
        for i in range(len(path) - 1):
            self.parent[path[i]] = root
            self.parity[path[i]] = to_root[i]
        return root, to_root[0]

    def union(self, a: int, b: int, flip: int) -> None:
        """Declare orientation(a) XOR orientation(b) == flip."""
        ra, pa = self.find_oriented(a)
        rb, pb = self.find_oriented(b)
        if ra == rb:
            return
        rel = pa ^ pb ^ flip
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        self.parity[rb] = rel
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1


def induce_graph(
    seqs: dict[str, bytes], paf_rows: list[dict],
    force_python_emit: bool = False,
) -> str:
    """Build an unchopped GFA from sequences + PAF rows (with packed runs).

    paf_rows: dicts with qname/qstart/qend/strand/tname/tstart/tend/runs
    (the align command's row format, or rows parsed from a PAF file).
    """
    names = list(seqs)
    offsets = {}
    total = 0
    for n in names:
        offsets[n] = total
        total += len(seqs[n])
    # Collect match runs as (query start, query direction, target start,
    # length, parity) tuples; the per-base unions run in one native batch
    # (native/seqwish_uf.cpp) with a pure-Python fallback.
    run_a: list[int] = []
    run_dir: list[int] = []
    run_b: list[int] = []
    run_len_l: list[int] = []
    run_flip: list[int] = []
    for row in paf_rows:
        q_off = offsets[row["qname"]]
        t_off = offsets[row["tname"]]
        strand = row["strand"]
        runs = row["runs"]
        lens = cigar.run_len(runs)
        ops = cigar.run_op(runs)
        t_pos = row["tstart"]
        # Query walk: forward from qstart for '+', backward from qend for '-'
        # (CIGAR walks target-forward = RC(query)-forward).
        q_pos = row["qstart"] if strand == "+" else row["qend"] - 1
        q_dir = 1 if strand == "+" else -1
        for length, op in zip(lens.tolist(), ops.tolist()):
            if op == cigar.OP_EQ:
                run_a.append(q_off + q_pos)
                run_dir.append(q_dir)
                run_b.append(t_off + t_pos)
                run_len_l.append(length)
                run_flip.append(0 if strand == "+" else 1)
                q_pos += q_dir * length
                t_pos += length
            elif op == cigar.OP_X or op == cigar.OP_M:
                q_pos += q_dir * length
                t_pos += length
            elif op == cigar.OP_I:
                q_pos += q_dir * length
            elif op == cigar.OP_D:
                t_pos += length

    roots = np.empty(total, np.int64)
    orient = np.empty(total, np.uint8)
    from impg_tpu_torch.io import native as native_mod

    lib = native_mod.load()
    if lib is not None:
        h = lib.uf_create(total)
        try:
            lib.uf_union_runs(
                h,
                np.asarray(run_a, np.int64),
                np.asarray(run_dir, np.int8),
                np.asarray(run_b, np.int64),
                np.asarray(run_len_l, np.int64),
                np.asarray(run_flip, np.uint8),
                len(run_a),
            )
            lib.uf_find_all(h, roots, orient, total)
        finally:
            lib.uf_destroy(h)
    else:
        uf = _BidirectedUF(total)
        for a, d, b, ln, fl in zip(
            run_a, run_dir, run_b, run_len_l, run_flip
        ):
            for i in range(ln):
                uf.union(a + d * i, b + i, fl)
        for i in range(total):
            r, p = uf.find_oriented(i)
            roots[i] = r
            orient[i] = p

    # Class -> node id; node base = root's base (canonical orientation = the
    # root's own orientation).  Vectorized: classes in first-occurrence
    # order (matching the previous per-base scan), bases gathered by root.
    all_bases = np.frombuffer(
        b"".join(seqs[n] for n in names), np.uint8
    )
    uniq_roots, first_idx, inverse = np.unique(
        roots, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx)  # first-occurrence order
    rank_of_sorted = np.empty(uniq_roots.size, np.int64)
    rank_of_sorted[order] = np.arange(uniq_roots.size)
    cls = rank_of_sorted[inverse]  # class id per base
    node_base_arr = np.empty(uniq_roots.size, np.uint8)
    node_base_arr[rank_of_sorted] = all_bases[uniq_roots]
    node_base = node_base_arr.tolist()
    n_nodes = len(node_base)

    # Native chain compaction + emission (native/seqwish_emit.cpp); the
    # Python tail below is the fallback and the semantics oracle.
    if not force_python_emit and lib is not None:
        import ctypes

        seq_offsets = np.asarray(
            [offsets[n] for n in names] + [total], np.int64
        )
        labels = "\n".join(
            f"{n}:0-{len(seqs[n])}" for n in names
        ).encode()
        out_len = ctypes.c_int64(0)
        ptr = lib.impg_seqwish_emit(
            len(names), seq_offsets, np.ascontiguousarray(cls, np.int64),
            np.ascontiguousarray(orient, np.uint8), n_nodes,
            np.ascontiguousarray(node_base_arr, np.uint8), labels,
            ctypes.byref(out_len),
        )
        if ptr:
            try:
                return ctypes.string_at(ptr, out_len.value).decode()
            finally:
                lib.impg_seqwish_emit_free(ptr)
        # Native allocation failed: fall through to the Python emitter.

    # Per-sequence walks: (node, orientation) per base.
    walks: dict[str, list[tuple[int, int]]] = {}
    edges: set[tuple[int, int, int, int]] = set()
    for n in names:
        off = offsets[n]
        L = len(seqs[n])
        wc = cls[off : off + L]
        wo = orient[off : off + L].astype(np.int64)
        walks[n] = list(zip(wc.tolist(), wo.tolist()))
        if L > 1:
            quad = np.stack(
                [wc[:-1], wo[:-1], wc[1:], wo[1:]], axis=1
            )
            for a, ao, b, bo in np.unique(quad, axis=0).tolist():
                edges.add((int(a), int(ao), int(b), int(bo)))

    # Unchop: merge chains of single-base nodes where the edge is the unique
    # continuation in both directions (same logic as graph/poa.py, on the
    # oriented graph restricted to forward-normalized steps).
    succs: dict[tuple[int, int], set] = {}
    preds: dict[tuple[int, int], set] = {}
    for a, ao, b, bo in edges:
        succs.setdefault((a, ao), set()).add((b, bo))
        preds.setdefault((b, bo), set()).add((a, ao))
        # The reverse traversal of the same edge.
        succs.setdefault((b, bo ^ 1), set()).add((a, ao ^ 1))
        preds.setdefault((a, ao ^ 1), set()).add((b, bo ^ 1))

    path_starts = {walks[n][0] for n in names if walks[n]}
    path_ends = {walks[n][-1] for n in names if walks[n]}
    # Breaks also at the reverse-orientation images of endpoints.
    path_starts |= {(v, o ^ 1) for v, o in path_ends}
    path_ends |= {(v, o ^ 1) for v, o in path_starts}

    def uniq_next(step):
        s = succs.get(step, set())
        return next(iter(s)) if len(s) == 1 else None

    def uniq_prev(step):
        s = preds.get(step, set())
        return next(iter(s)) if len(s) == 1 else None

    # Assign each oriented node to a chain; a node and its flip share a
    # segment (orientation encoded in the step).  Work on node ids only:
    # chain over nodes using the forward orientation representative.
    chain_of: dict[int, tuple[int, int]] = {}  # node -> (segment id, idx)
    segments: list[list[tuple[int, int]]] = []  # oriented node lists

    def can_link(a_step, b_step) -> bool:
        return (
            uniq_next(a_step) == b_step
            and uniq_prev(b_step) == a_step
            and b_step not in path_starts
            and a_step not in path_ends
        )

    visited = set()
    for n in names:
        for step in walks[n]:
            node = step[0]
            if node in visited:
                continue
            # Normalize to this step's orientation for chain discovery.
            cur = step
            # Walk back to chain head.
            while True:
                prev = uniq_prev(cur)
                if prev is None or prev[0] in visited or not can_link(prev, cur):
                    break
                cur = prev
            head = cur
            seg = [cur]
            visited.add(cur[0])
            while True:
                nxt = uniq_next(cur)
                if nxt is None or nxt[0] in visited or not can_link(cur, nxt):
                    break
                seg.append(nxt)
                visited.add(nxt[0])
                cur = nxt
            sid = len(segments)
            segments.append(seg)
            for idx, (v, o) in enumerate(seg):
                chain_of[v] = (sid, idx)

    # Segment sequences in the orientation recorded in `segments`.
    def base_char(node: int, o: int) -> int:
        b = node_base[node]
        return b if o == 0 else _COMP.get(b, b)

    seg_seq = [
        bytes(base_char(v, o) for v, o in seg) for seg in segments
    ]

    # Paths as segment steps: entering a segment at its head (forward) or
    # tail (reverse).
    lines = ["H\tVN:Z:1.0"]
    for sid, seq in enumerate(seg_seq):
        lines.append(f"S\t{sid + 1}\t{seq.decode()}")
    link_set = set()
    path_lines = []
    for n in names:
        steps = []
        walk = walks[n]
        i = 0
        while i < len(walk):
            v, o = walk[i]
            sid, idx = chain_of[v]
            seg = segments[sid]
            fwd = seg[idx] == (v, o)
            steps.append((sid, 0 if fwd else 1))
            i += len(seg) if len(seg) <= len(walk) - i else len(walk) - i
            # Advance exactly the segment length along the walk.
        path_lines.append(
            f"P\t{n}:0-{len(seqs[n])}\t"
            + ",".join(f"{s + 1}{'-' if o else '+'}" for s, o in steps)
            + "\t*"
        )
        for (a, ao), (b, bo) in zip(steps, steps[1:]):
            link_set.add((a, ao, b, bo))
    for a, ao, b, bo in sorted(link_set):
        lines.append(
            f"L\t{a + 1}\t{'-' if ao else '+'}\t{b + 1}\t{'-' if bo else '+'}\t0M"
        )
    lines.extend(path_lines)
    return "\n".join(lines) + "\n"
