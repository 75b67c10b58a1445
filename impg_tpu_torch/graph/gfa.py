"""GFA dict model: parse (S/L/P, and GFA 1.1 W lines) and write.

The port's copy of impg_tpu/graph/gfa.py's `Gfa.parse`, `Gfa.parse_python`,
`Gfa.write`, `topological_sort` (the `sort` stage of `-o gfa:`, stable Kahn
order with renumbering), `_numeric_key`, `chop_gfa` (smooth's chop),
`_parse_w_walk` and `_split_walk_name`.  `parse` tokenizes
through the port's native GFA parser (graph/gfa_columns.py) and falls back
to `parse_python`, the tokenizer-free oracle, only where impg_tpu's does:
when the native library is not there.  Graph genotyping and `map --graph`
(genotype/graph.py) read their graphs with `parse`; the `sort` path runs on
the columnar model and needs only `_split_walk_name` (the W-line names of
graph/columnar_ops.write_columns).  `report` belongs to `graph-report`'s
slice, not ported yet.  Blunt GFAs (0M overlaps).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Gfa:
    segments: dict[str, str] = field(default_factory=dict)  # id -> seq
    links: list[tuple[str, bool, str, bool]] = field(default_factory=list)
    paths: list[tuple[str, list[tuple[str, bool]]]] = field(default_factory=list)
    header: str = "H\tVN:Z:1.0"
    # Names of paths imported from GFA 1.1 W lines (re-emitted as W).
    walk_names: set = field(default_factory=set)

    @classmethod
    def parse(cls, text: str) -> "Gfa":
        """The dict model of `text` through the native tokenizer; a bad W
        walk raises ValueError.  Without the native library (RuntimeError
        from the tokenizer) the pure-Python parse gives the same object."""
        from impg_tpu_torch.graph.gfa_columns import parse_gfa_columns

        try:
            gc = parse_gfa_columns(text)
        except RuntimeError:
            return cls.parse_python(text)
        return gc.to_gfa()

    @classmethod
    def parse_python(cls, text: str) -> "Gfa":
        """Pure-Python parse (the oracle for the native tokenizer)."""
        g = cls()
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            f = line.split("\t")
            if f[0] == "H":
                g.header = line
            elif f[0] == "S" and len(f) >= 3:
                g.segments[f[1]] = f[2]
            elif f[0] == "L" and len(f) >= 6:
                g.links.append((f[1], f[2] == "-", f[3], f[4] == "-"))
            elif f[0] == "P" and len(f) >= 3:
                steps = [(s[:-1], s.endswith("-")) for s in f[2].split(",") if s]
                g.paths.append((f[1], steps))
            elif f[0] == "W" and len(f) >= 7:
                # GFA 1.1 walk: W sample hap seq start end >1<2...
                # Imported as a path named PanSN-style with the range.
                name = f"{f[1]}#{f[2]}#{f[3]}:{f[4]}-{f[5]}"
                steps = _parse_w_walk(f[6])
                g.paths.append((name, steps))
                g.walk_names.add(name)
        return g

    def write(self) -> str:
        lines = [self.header]
        for sid, seq in self.segments.items():
            lines.append(f"S\t{sid}\t{seq}")
        for a, ar, b, br in self.links:
            lines.append(
                f"L\t{a}\t{'-' if ar else '+'}\t{b}\t{'-' if br else '+'}\t0M"
            )
        for name, steps in self.paths:
            if name in self.walk_names:
                parsed = _split_walk_name(name)
                if parsed is not None:
                    sample, hap, seq, start, end = parsed
                    walk = "".join(
                        f"{'<' if r else '>'}{s}" for s, r in steps
                    )
                    lines.append(
                        f"W\t{sample}\t{hap}\t{seq}\t{start}\t{end}\t{walk}"
                    )
                    continue
            walk = ",".join(f"{s}{'-' if r else '+'}" for s, r in steps)
            lines.append(f"P\t{name}\t{walk}\t*")
        return "\n".join(lines) + "\n"


def topological_sort(gfa: Gfa) -> Gfa:
    """Renumber segments 1..N in stable topological order (links treated as
    undirected-orientation DAG edges from->to; cycles broken by input order)."""
    order: list[str] = []
    indeg: dict[str, int] = {sid: 0 for sid in gfa.segments}
    succs: dict[str, list[str]] = {sid: [] for sid in gfa.segments}
    for a, _, b, _ in gfa.links:
        if a in indeg and b in indeg and a != b:
            succs[a].append(b)
            indeg[b] += 1
    ready = sorted(
        (sid for sid, d in indeg.items() if d == 0),
        key=lambda s: _numeric_key(s),
    )
    seen = set()
    while ready:
        v = ready.pop(0)
        if v in seen:
            continue
        seen.add(v)
        order.append(v)
        newly = []
        for w in succs[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                newly.append(w)
        ready.extend(sorted(newly, key=_numeric_key))
    # Cycle remnants: append in input order.
    for sid in gfa.segments:
        if sid not in seen:
            order.append(sid)

    rename = {old: str(i + 1) for i, old in enumerate(order)}
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    for old in order:
        out.segments[rename[old]] = gfa.segments[old]
    out.links = [
        (rename[a], ar, rename[b], br)
        for a, ar, b, br in gfa.links
        if a in rename and b in rename
    ]
    out.paths = [
        (name, [(rename[s], r) for s, r in steps if s in rename])
        for name, steps in gfa.paths
    ]
    return out


def _numeric_key(s: str):
    try:
        return (0, int(s), "")
    except ValueError:
        return (1, 0, s)


def chop_gfa(gfa: Gfa, max_len: int) -> Gfa:
    """Split segments longer than `max_len` into consecutive pieces
    (smooth.rs:332 chop_graph role; odgi-chop semantics).  Path steps
    expand in walk order — reverse steps traverse the pieces backwards
    with flipped orientation — and links regenerate from the paths, so
    every path spells exactly the same bases."""
    if max_len <= 0:
        return gfa
    out = Gfa(header=gfa.header, walk_names=set(gfa.walk_names))
    pieces: dict[str, list[str]] = {}
    next_id = 1
    for sid, seq in gfa.segments.items():
        ids = []
        for off in range(0, max(len(seq), 1), max_len):
            nid = str(next_id)
            next_id += 1
            out.segments[nid] = seq[off : off + max_len]
            ids.append(nid)
        pieces[sid] = ids
    link_set: set[tuple[str, bool, str, bool]] = set()
    for name, steps in gfa.paths:
        new_steps: list[tuple[str, bool]] = []
        for sid, rev in steps:
            ids = pieces[sid]
            new_steps.extend(
                (p, rev) for p in (reversed(ids) if rev else ids)
            )
        out.paths.append((name, new_steps))
        for (a, ar), (b, br) in zip(new_steps, new_steps[1:]):
            link_set.add((a, ar, b, br))
    out.links = sorted(link_set, key=lambda l: (_numeric_key(l[0]), l[1],
                                                _numeric_key(l[2]), l[3]))
    return out


def _parse_w_walk(walk: str) -> list[tuple[str, bool]]:
    """'>1<2' oriented steps of a GFA 1.1 W line."""
    steps: list[tuple[str, bool]] = []
    i = 0
    while i < len(walk):
        orient = walk[i]
        if orient not in "><":
            raise ValueError(f"invalid W walk orientation at {i}: {walk}")
        j = i + 1
        while j < len(walk) and walk[j] not in "><":
            j += 1
        steps.append((walk[i + 1 : j], orient == "<"))
        i = j
    return steps


def _split_walk_name(name: str):
    """sample#hap#seq:start-end back into W-line fields, or None."""
    base, _, rng = name.rpartition(":")
    parts = base.split("#")
    if len(parts) != 3 or "-" not in rng:
        return None
    s, _, e = rng.partition("-")
    try:
        return parts[0], parts[1], parts[2], int(s), int(e)
    except ValueError:
        return None
