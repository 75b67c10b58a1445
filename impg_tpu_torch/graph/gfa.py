"""GFA dict model: the pure-Python parse (S/L/P, and GFA 1.1 W lines).

The port's copy of impg_tpu/graph/gfa.py's `Gfa.parse_python`,
`_parse_w_walk` and `_split_walk_name`.  The `sort` path runs on the
columnar model (graph/gfa_columns.py) and needs only `_split_walk_name` (the
W-line names of graph/columnar_ops.write_columns); `Gfa.parse_python` is the
tokenizer-free oracle the port's tests read sorted graphs with.  The native
dispatching `parse`, `write`, `report`, `topological_sort` and `chop_gfa`
belong to slices not ported yet.  Blunt GFAs (0M overlaps).
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
