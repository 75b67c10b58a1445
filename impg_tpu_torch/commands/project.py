"""GAF -> GFA-segment pack projection (`impg project` role).

Reference: projection/converter.rs:532 `project_gaf_to_gfa` — walk each GAF
record's listed graph walk, count every step that overlaps the record's
[path_start, path_end) interval (walk-relative coordinates), and emit a
typed pack TSV over GFA-segment feature ids plus an auditable per-step
read-contribution table; `-o proj` wraps those in a projection bundle
directory with a manifest (converter.rs:564).  Feature-id resolution and
the graph fingerprint mirror commands/genotype.rs:1217
`resolve_feature_id_mode` / :1264 `graph_id_for` (FNV-1a over the
normalized segment and path records) so packs and graphs can be paired.

The port's copy of impg_tpu/commands/project.py, on the host as there
(tests/test_torch_render_project.py holds every file equal).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from dataclasses import dataclass, field

from impg_tpu_torch.graph.gfa import Gfa

FEATURE_SPACE = "gfa-segment"
PROJECTION_METHOD = "gaf-to-gfa"
PACK_NAME = "sample.pack.tsv"
GAF_NAME = "alignments.gaf"
CONTRIB_NAME = "read-contributions.tsv"

_FNV_PRIME = 0x0000_0100_0000_01B3
_MASK64 = (1 << 64) - 1


def _fnv1a_update(h: int, data: bytes) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    h = ((h ^ 0xFF) * _FNV_PRIME) & _MASK64
    return h


def resolve_feature_id_mode(segment_names: list[str], requested: str) -> str:
    """'auto' picks segment-name when every S-line name is a unique positive
    u32, else dense import order (genotype.rs:1217)."""

    def names_ok() -> bool:
        seen = set()
        for name in segment_names:
            try:
                v = int(name)
            except ValueError:
                return False
            if not (0 < v < 2**32) or v in seen or str(v) != name:
                return False
            seen.add(v)
        return True

    if requested == "auto":
        return "segment-name" if names_ok() else "dense"
    if requested == "dense":
        return "dense"
    if requested == "segment-name":
        if not names_ok():
            raise ValueError(
                "--graph-feature-id-mode segment-name requires every GFA "
                "S-line name to be a unique positive u32"
            )
        return "segment-name"
    raise ValueError(f"unknown feature-id mode '{requested}'")


def feature_ids_for(gfa: Gfa, effective_mode: str) -> dict[str, int]:
    if effective_mode == "segment-name":
        return {name: int(name) for name in gfa.segments}
    return {name: i + 1 for i, name in enumerate(gfa.segments)}


def graph_id_for(gfa: Gfa, effective_mode: str, fids: dict[str, int]) -> str:
    """FNV-1a fingerprint over the normalized graph (genotype.rs:1264)."""
    h = 0xCBF2_9CE4_8422_2325
    h = _fnv1a_update(h, FEATURE_SPACE.encode())
    h = _fnv1a_update(h, effective_mode.encode())
    for name, seq in gfa.segments.items():
        h = _fnv1a_update(h, b"S")
        h = _fnv1a_update(h, name.encode())
        h = _fnv1a_update(h, str(fids[name]).encode())
        h = _fnv1a_update(h, str(len(seq)).encode())
        if seq and seq != "*":
            h = _fnv1a_update(h, seq.encode())
    for pname, steps in gfa.paths:
        h = _fnv1a_update(h, b"P")
        h = _fnv1a_update(h, pname.encode())
        h = _fnv1a_update(h, b"W" if pname in gfa.walk_names else b"P")
        for sid, rev in steps:
            h = _fnv1a_update(h, sid.encode())
            h = _fnv1a_update(h, b"-" if rev else b"+")
    return f"{h:016x}"


def parse_gaf_walk(path_field: str, line_no: int) -> list[tuple[str, str]]:
    """Oriented walk steps [(segment name, '+'|'-')] from a GAF path field:
    `>a<b` graph-walk syntax or `a+,b-` comma tokens (converter.rs:192)."""
    if not path_field or path_field == "*":
        raise ValueError(f"GAF line {line_no} does not contain a graph walk")
    if path_field[0] in "><":
        steps = []
        for tok in re.findall(r"[<>][^<>]*", path_field):
            if len(tok) < 2:
                raise ValueError(
                    f"GAF line {line_no} has an empty graph-walk step"
                )
            steps.append((tok[1:], "+" if tok[0] == ">" else "-"))
        return steps
    if "," in path_field or path_field[-1] in "+-":
        steps = []
        for tok in path_field.split(","):
            if len(tok) < 2 or tok[-1] not in "+-":
                raise ValueError(
                    f"GAF line {line_no} has invalid comma-walk token "
                    f"'{tok}'"
                )
            steps.append((tok[:-1], tok[-1]))
        return steps
    raise ValueError(
        f"GAF line {line_no} path field '{path_field}' is not an oriented "
        "graph walk over GFA segment names"
    )


@dataclass
class ProjectionResult:
    counts: dict[int, int] = field(default_factory=dict)
    contributions: list[tuple] = field(default_factory=list)
    total_records: int = 0
    retained_records: int = 0
    contributed_steps: int = 0


def project_gaf(
    gaf_path: str,
    seg_lengths: dict[str, int],
    fids: dict[str, int],
) -> ProjectionResult:
    """Count one pack unit per walk step overlapping the record's
    [path_start, path_end) walk interval (converter.rs:268
    project_gaf_records)."""
    res = ProjectionResult()
    with open(gaf_path) as fh:
        for line_idx, line in enumerate(fh):
            line_no = line_idx + 1
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            f = line.split("\t")
            if len(f) < 12:
                raise ValueError(
                    f"GAF line {line_no} has {len(f)} field(s); expected "
                    "at least 12"
                )
            res.total_records += 1
            read_name = f[0]
            path_start, path_end = int(f[7]), int(f[8])
            if path_end <= path_start:
                raise ValueError(
                    f"GAF line {line_no} has empty path interval "
                    f"{path_start}-{path_end}"
                )
            walk = parse_gaf_walk(f[5], line_no)
            cursor = 0
            retained = False
            visits: dict[str, int] = {}
            for step_idx, (seg, orient) in enumerate(walk):
                if seg not in seg_lengths:
                    raise ValueError(
                        f"GAF line {line_no} references unknown GFA "
                        f"segment '{seg}'"
                    )
                s0, s1 = cursor, cursor + seg_lengths[seg]
                cursor = s1
                if min(s1, path_end) <= max(s0, path_start):
                    continue
                retained = True
                res.contributed_steps += 1
                fid = fids[seg]
                res.counts[fid] = res.counts.get(fid, 0) + 1
                visits[seg] = visits.get(seg, 0) + 1
                v = visits[seg]
                explanation = (
                    "first visit to segment in read; counted"
                    if v == 1
                    else f"repeated visit {v} to segment in read; "
                    "counted again"
                )
                res.contributions.append(
                    (
                        read_name,
                        res.total_records,
                        step_idx + 1,
                        seg,
                        orient,
                        fid,
                        v,
                        1,
                        explanation,
                    )
                )
            if path_end > cursor:
                raise ValueError(
                    f"GAF line {line_no} path_end {path_end} exceeds "
                    f"graph-walk length {cursor}"
                )
            if retained:
                res.retained_records += 1
    return res


def write_pack_tsv(
    path: str,
    counts: dict[int, int],
    graph_id: str,
    feature_id_mode: str,
    contribution_model: str,
) -> int:
    rows = sorted((fid, c) for fid, c in counts.items() if c > 0)
    with open(path, "w") as out:
        out.write(f"#feature_space\t{FEATURE_SPACE}\n")
        out.write(f"#graph_id\t{graph_id}\n")
        out.write(f"#feature_id_mode\t{feature_id_mode}\n")
        out.write(f"#graph_contribution_model\t{contribution_model}\n")
        out.write(f"#projection_method\t{PROJECTION_METHOD}\n")
        out.write("#node_id\tcount\n")
        for fid, c in rows:
            out.write(f"{fid}\t{c}\n")
    return len(rows)


def write_read_contributions(path: str, rows: list[tuple]) -> None:
    with open(path, "w") as out:
        out.write(
            "read_name\tread_ordinal\tstep_index\tsegment_name\t"
            "orientation\tfeature_id\tsegment_visit_in_read\tcount_delta\t"
            "explanation\n"
        )
        for row in rows:
            out.write("\t".join(str(v) for v in row) + "\n")


def run_project(
    gfa_path: str,
    gaf_path: str,
    output: str,
    output_format: str = "proj",
    feature_id_mode: str = "auto",
    contribution_model: str = "raw",
    read_contributions: str | None = None,
) -> dict:
    """Project a GAF onto a GFA's segment feature space.  Returns a summary
    dict (converter.rs GfaProjectionSummary role)."""
    if output_format in ("proj", "projection", "projection-bundle", "bundle"):
        output_format = "proj"
    elif output_format in ("pack", "pack-tsv", "pack-text", "packtsv"):
        output_format = "pack-tsv"
    else:
        raise ValueError(
            f"unsupported project output format '{output_format}'; "
            "expected 'proj' or 'pack-tsv'"
        )
    if output_format == "proj" and read_contributions:
        raise ValueError(
            "--read-contributions is only used with -o pack-tsv; projection "
            "bundles write read-contributions.tsv inside the bundle"
        )

    with open(gfa_path) as fh:
        gfa = Gfa.parse(fh.read())
    effective = resolve_feature_id_mode(list(gfa.segments), feature_id_mode)
    fids = feature_ids_for(gfa, effective)
    seg_lengths = {name: len(seq) for name, seq in gfa.segments.items()}
    graph_id = graph_id_for(gfa, effective, fids)
    res = project_gaf(gaf_path, seg_lengths, fids)

    summary = dict(
        feature_space=FEATURE_SPACE,
        graph_id=graph_id,
        feature_id_mode=effective,
        contribution_model=contribution_model,
        total_records=res.total_records,
        retained_records=res.retained_records,
        contributed_steps=res.contributed_steps,
    )
    if output_format == "proj":
        os.makedirs(output, exist_ok=True)
        pack_path = os.path.join(output, PACK_NAME)
        summary["nonzero_features"] = write_pack_tsv(
            pack_path, res.counts, graph_id, effective, contribution_model
        )
        write_read_contributions(
            os.path.join(output, CONTRIB_NAME), res.contributions
        )
        shutil.copy(gaf_path, os.path.join(output, GAF_NAME))
        manifest = dict(
            format="impg-tpu-projection-bundle",
            version=1,
            projection_method=PROJECTION_METHOD,
            graph=gfa_path,
            gaf=GAF_NAME,
            pack=PACK_NAME,
            read_contributions=CONTRIB_NAME,
            feature_space=FEATURE_SPACE,
            graph_id=graph_id,
            feature_id_mode=effective,
            contribution_model=contribution_model,
            read_space="gaf-graph-walk",
        )
        with open(os.path.join(output, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=2)
        summary["output_path"] = output
        summary["pack_path"] = pack_path
    else:
        parent = os.path.dirname(output)
        if parent:
            os.makedirs(parent, exist_ok=True)
        summary["nonzero_features"] = write_pack_tsv(
            output, res.counts, graph_id, effective, contribution_model
        )
        if read_contributions:
            write_read_contributions(read_contributions, res.contributions)
        summary["output_path"] = output
        summary["pack_path"] = output
    return summary


def load_projection_bundle(path: str) -> dict:
    """Read a bundle manifest and resolve its file paths
    (converter.rs:452 load_gfa_projection_bundle)."""
    manifest_path = os.path.join(path, "manifest.json")
    with open(manifest_path) as fh:
        manifest = json.load(fh)
    if manifest.get("feature_space") not in (
        "gfa-segment",
        "variation-graph-node",
    ):
        raise ValueError(
            f"projection feature_space '{manifest.get('feature_space')}' "
            "is not a graph-node feature space"
        )

    def resolve(p: str) -> str:
        return p if os.path.isabs(p) else os.path.join(path, p)

    return dict(
        manifest,
        pack_path=resolve(manifest["pack"]),
        gaf_path=resolve(manifest["gaf"]),
        read_contributions_path=(
            resolve(manifest["read_contributions"])
            if manifest.get("read_contributions")
            else None
        ),
    )
