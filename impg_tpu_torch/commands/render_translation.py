"""Render-bundle step-translation tables.

Role model: render_bundle.rs:40 StepTranslationRecord +
commands/render.rs:452 collect_gfa_step_samples — every rendered path's
graph walk is sampled step by step, recording where each step lands on the
SOURCE sequence (strand-aware) and which graph feature (segment id) it
traverses.  Downstream tools project rendered-graph coordinates back to
source coordinates through these tables.

Artifacts inside a render bundle:
  * ``translation.npz`` — the binary tables as flat arrays (the
    translation.bin role): per-step (rendered_path_id, rendered_step,
    source_bp, feature_id, orientation) plus the rendered-path records;
  * ``translation.tsv`` — the human-readable mirror.

The port's copy of impg_tpu/commands/render_translation.py
(tests/test_torch_render_project.py holds the tables equal, the npz by its
members).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


@dataclass
class RenderedPath:
    rendered_path_id: int
    rendered_name: str
    source_name: str
    source_sequence_id: int
    start: int
    end: int
    strand: str


def _parse_walk(field: str) -> list[tuple[str, str]]:
    if field in ("*", ""):
        return []
    return [(s[:-1], s[-1]) for s in field.split(",") if s]


def collect_gfa_step_samples(
    gfa_text: str, rendered: list[RenderedPath]
) -> list[tuple[int, int, int, int, str]]:
    """(rendered_path_id, rendered_step, source_bp, feature_id,
    orientation) per path step (commands/render.rs:452): source_bp walks
    the source interval forward for '+' paths and backward from its end
    for '-' paths."""
    seg_len: dict[str, int] = {}
    feature_of: dict[str, int] = {}
    walks: dict[str, list[tuple[str, str]]] = {}
    for line in gfa_text.splitlines():
        f = line.split("\t")
        if f[0] == "S" and len(f) >= 3:
            seg_len[f[1]] = len(f[2])
            try:
                feature_of[f[1]] = int(f[1])
            except ValueError:
                feature_of[f[1]] = len(feature_of) + 1
        elif f[0] == "P" and len(f) >= 3:
            walks[f[1]] = _parse_walk(f[2])

    def find_walk(name: str):
        if name in walks:
            return walks[name]
        prefix = name + ":"
        hits = [w for n, w in walks.items() if n.startswith(prefix)]
        return hits[0] if len(hits) == 1 else None

    records: list[tuple[int, int, int, int, str]] = []
    for rp in rendered:
        walk = find_walk(rp.rendered_name)
        if walk is None:
            continue
        offset = 0
        for step_idx, (sid, orientation) in enumerate(walk):
            ln = seg_len.get(sid, 0)
            if rp.strand == "+":
                source_bp = rp.start + offset
            else:
                source_bp = max(rp.end - (offset + ln), 0)
            records.append(
                (
                    rp.rendered_path_id,
                    step_idx,
                    source_bp,
                    feature_of.get(sid, 0),
                    orientation,
                )
            )
            offset += ln
    return records


def write_translation(
    bundle_dir: str,
    rendered: list[RenderedPath],
    steps: list[tuple[int, int, int, int, str]],
) -> tuple[str, str]:
    """Write translation.npz + translation.tsv; returns their paths."""
    npz_path = os.path.join(bundle_dir, "translation.npz")
    tsv_path = os.path.join(bundle_dir, "translation.tsv")
    np.savez_compressed(
        npz_path,
        version=np.int64(1),
        rp_id=np.asarray([r.rendered_path_id for r in rendered], np.int32),
        rp_name=np.asarray([r.rendered_name for r in rendered], str),
        rp_source_id=np.asarray(
            [r.source_sequence_id for r in rendered], np.int32
        ),
        rp_source_name=np.asarray([r.source_name for r in rendered], str),
        rp_start=np.asarray([r.start for r in rendered], np.int64),
        rp_end=np.asarray([r.end for r in rendered], np.int64),
        rp_strand=np.asarray(
            [0 if r.strand == "+" else 1 for r in rendered], np.int8
        ),
        step_path=np.asarray([s[0] for s in steps], np.int32),
        step_idx=np.asarray([s[1] for s in steps], np.int32),
        step_source_bp=np.asarray([s[2] for s in steps], np.int64),
        step_feature=np.asarray([s[3] for s in steps], np.int64),
        step_orient=np.asarray(
            [0 if s[4] == "+" else 1 for s in steps], np.int8
        ),
    )
    by_id = {r.rendered_path_id: r for r in rendered}
    with open(tsv_path, "w") as fh:
        fh.write(
            "#type\trendered_path_id\trendered_name\tsource_id\t"
            "source_name\tsource_start\tsource_end\tstrand\t"
            "rendered_step\tfeature_id\torientation\n"
        )
        for r in rendered:
            fh.write(
                f"path\t{r.rendered_path_id}\t{r.rendered_name}\t"
                f"{r.source_sequence_id}\t{r.source_name}\t{r.start}\t"
                f"{r.end}\t{r.strand}\t.\t.\t.\n"
            )
        for pid, sidx, bp, fid, orient in steps:
            r = by_id[pid]
            fh.write(
                f"step\t{pid}\t{r.rendered_name}\t{r.source_sequence_id}\t"
                f"{r.source_name}\t{bp}\t{bp}\t{r.strand}\t{sidx}\t{fid}\t"
                f"{orient}\n"
            )
    return npz_path, tsv_path


def load_translation(bundle_dir: str):
    """Load the binary tables back (render_bundle.rs:331 role)."""
    with np.load(
        os.path.join(bundle_dir, "translation.npz"), allow_pickle=False
    ) as z:
        rendered = [
            RenderedPath(
                rendered_path_id=int(z["rp_id"][i]),
                rendered_name=str(z["rp_name"][i]),
                source_name=str(z["rp_source_name"][i]),
                source_sequence_id=int(z["rp_source_id"][i]),
                start=int(z["rp_start"][i]),
                end=int(z["rp_end"][i]),
                strand="+" if int(z["rp_strand"][i]) == 0 else "-",
            )
            for i in range(len(z["rp_id"]))
        ]
        steps = [
            (
                int(z["step_path"][i]),
                int(z["step_idx"][i]),
                int(z["step_source_bp"][i]),
                int(z["step_feature"][i]),
                "+" if int(z["step_orient"][i]) == 0 else "-",
            )
            for i in range(len(z["step_path"]))
        ]
    return rendered, steps
