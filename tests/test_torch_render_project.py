"""The port's GFA toolbox, part three, against impg_tpu on the CPU: `render`
and `project`.

commands/render_translation.py (`collect_gfa_step_samples`,
`write_translation`, `load_translation`) and commands/project.py
(`parse_gaf_walk`, feature ids, the graph fingerprint, `project_gaf`,
`run_project`, `load_projection_bundle`) by value; then each command's
exit status, stdout, stderr and every file it writes equal to
impg_tpu.cli's on the same seeded inputs:

  * `render` bundles of one window of `synth.panel_alignments(seed=7)` cut
    to 8 haplotypes of 12 kb, with and without `-x`, on every
    `--gfa-engine`, with `--render-graph`: render.fa, render.gfa,
    namespace.tsv and .json, translation.tsv, manifest.json and
    render.svg by bytes, region.syngt and translation.npz (numpy zips
    whose bytes carry write times) by their members' bytes; the manifest
    names every file the bundle holds;
  * `project` of tests/test_project.py's graph and GAF and of the GAF that
    `map --graph -o gaf` writes for reads of the panel's window graph: the
    `proj` bundle and `pack-tsv` (with and without `--read-contributions`),
    both `--graph-feature-id-mode` and `--graph-contribution-model` values,
    and its errors.  Exact throughout."""

import json
import os
import random

import pytest

import impg_tpu.cli as jax_cli
from impg_tpu.commands import project as jax_project
from impg_tpu.commands import render_translation as jax_rt
from impg_tpu_torch.commands import project as port_project
from impg_tpu_torch.commands import render_translation as port_rt
from tests.test_project import GAF_ROWS, GFA
from tests.test_torch_gfa_tools import panel_files, read_output, run_both
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def read_tree(root: str, side_dir: str) -> dict | None:
    """Every file under `root` by its relative path (read_output's
    content; text with `side_dir` written as <d>), or None."""
    if not os.path.isdir(root):
        return None
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            v = read_output(p)
            if isinstance(v, bytes):
                v = v.replace(side_dir.encode(), b"<d>")
            out[os.path.relpath(p, root)] = v
    return out


@pytest.fixture(scope="module")
def panel_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_render")
    for side in ("jax", "port"):
        (tmp / side).mkdir()
        panel_files(tmp / side)
        (tmp / side / "seqs.txt").write_text(f"{tmp / side}/panel.fa\n")
    return tmp


RENDER_CASES = {
    "poa_x": ["-x"],
    "poa_direct": [],
    "poa_x_svg": ["-x", "--render-graph", "-m", "1"],
    "seqwish_x": ["-x", "--gfa-engine", "seqwish"],
    "pggb_x_svg": ["-x", "--gfa-engine", "pggb", "--render-graph"],
    "syng_native": ["--gfa-engine", "syng-native", "-d", "500"],
    "sequence_list": ["-x", "--sequence-list", "{d}/seqs.txt"],
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_cli_render_equals_jax(panel_dirs, capsys, case):
    extra = RENDER_CASES[case]
    seqs = [] if "--sequence-list" in extra else ["--sequence-files",
                                                  "{d}/panel.fa"]
    argv = (["render", "-a", "{d}/panel.paf", "-r", "base:3000-4500",
             "-O", "{d}/" + case] + seqs
            + ([] if "-d" in extra else ["-d", "100"]) + extra)
    res = run_both(panel_dirs, argv, capsys)
    trees = [read_tree(str(panel_dirs / side / case), str(panel_dirs / side))
             for side in ("jax", "port")]
    assert res[0][:3] == res[1][:3] and res[0][0] == 0
    assert trees[0] == trees[1]
    tree = trees[1]
    manifest = json.loads(tree["manifest.json"])
    named = set(manifest["files"].values()) | {"manifest.json"}
    if "--render-graph" in extra:
        named.add("render.svg")  # written beside the manifest's files
    assert named == set(tree), (named, set(tree))
    assert manifest["n_paths"] >= 7 and manifest["step_samples"] > 0


@pytest.mark.parametrize("argv", [
    ["render", "-a", "{d}/panel.paf", "-r", "nope:0-10", "-d", "100",
     "--sequence-files", "{d}/panel.fa", "-O", "{d}/bad"],
    ["render", "-a", "{d}/panel.paf", "-r", "base:0-10", "-d", "100",
     "-O", "{d}/bad"],
    ["render", "-a", "{d}/panel.paf", "-r", "base:0-10", "-d", "1x",
     "--sequence-files", "{d}/panel.fa", "-O", "{d}/bad"],
], ids=["unknown_target", "no_sequences", "bad_distance"])
def test_cli_render_errors_equal_jax(panel_dirs, capsys, argv):
    res = run_both(panel_dirs, argv, capsys)
    assert res[0][:3] == res[1][:3] and res[0][0] in (1, 2)


def test_translation_tables_equal_jax(panel_dirs, capsys, tmp_path):
    """The step samples and the tables read back equal impg_tpu's."""
    d = panel_dirs / "port"
    assert jax_cli.main(["render", "-a", f"{d}/panel.paf", "-r",
                         "base:3000-4500", "-d", "100", "-x",
                         "--sequence-files", f"{d}/panel.fa", "-O",
                         str(tmp_path / "b")]) == 0
    gfa_text = (tmp_path / "b" / "render.gfa").read_text()
    rendered, steps = jax_rt.load_translation(str(tmp_path / "b"))
    paths = [port_rt.RenderedPath(**vars(r)) for r in rendered]
    samples = port_rt.collect_gfa_step_samples(gfa_text, paths)
    assert samples == jax_rt.collect_gfa_step_samples(gfa_text, rendered)
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    port_rt.write_translation(str(tmp_path / "p"), paths, samples)
    jax_rt.write_translation(str(tmp_path / "j"), rendered, samples)
    for f in ("translation.npz", "translation.tsv"):
        assert read_output(str(tmp_path / "p" / f)) == \
            read_output(str(tmp_path / "j" / f))
    got = port_rt.load_translation(str(tmp_path / "p"))
    assert [vars(r) for r in got[0]] == [vars(r) for r in rendered]
    assert got[1] == steps == samples


# ---- project ----------------------------------------------------------------


@pytest.fixture(scope="module")
def project_dirs(panel_dirs, tmp_path_factory):
    """Each side's directory: tests/test_project.py's graph and GAF, the
    same graph with non-numeric names, a GAF with an unknown segment, and
    the panel window's POA graph with the GAF of 60 reads of hap3 mapped
    onto it by impg_tpu's `map --graph -o gaf`."""
    import contextlib
    import io

    tmp = tmp_path_factory.mktemp("torch_project")
    src = panel_dirs / "jax"
    assert jax_cli.main(["render", "-a", f"{src}/panel.paf", "-r",
                         "base:3000-6000", "-d", "100", "-x",
                         "--sequence-files", f"{src}/panel.fa", "-O",
                         str(tmp / "b")]) == 0
    region = (tmp / "b" / "render.gfa").read_text()
    hap = (tmp / "b" / "render.fa").read_text().split(">")[1:]
    rng = random.Random(7)
    seq = "".join(hap[3].splitlines()[1:])
    with open(tmp / "reads.fq", "w") as fh:
        for i in range(60):
            s = rng.randint(0, len(seq) - 150)
            fh.write(f"@r{i}\n{seq[s:s + 150]}\n+\n{'I' * 150}\n")
    (tmp / "region.gfa").write_text(region)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert jax_cli.main(["map", "--graph", str(tmp / "region.gfa"),
                             "-q", str(tmp / "reads.fq"), "-o",
                             "gaf"]) == 0
    files = {
        "g.gfa": GFA,
        "r.gaf": "\n".join(GAF_ROWS) + "\n",
        "g2.gfa": GFA.replace("\t1\t", "\ts1\t").replace("1+", "s1+")
        .replace(">1", ">s1"),
        "r2.gaf": "r3\t4\t0\t4\t+\ts1+,2+\t12\t0\t4\t4\t4\t60\n",
        "bad.gaf": "r\t4\t0\t4\t+\t>zz\t8\t0\t4\t4\t4\t60\n",
        "region.gfa": region,
        "m.gaf": out.getvalue(),
    }
    assert files["m.gaf"].count("\n") >= 30
    for side in ("jax", "port"):
        (tmp / side).mkdir()
        for n, t in files.items():
            (tmp / side / n).write_text(t)
    return tmp


PROJECT_CASES = {
    "proj": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/r.gaf", "-O", "{d}/o.proj"],
    "pack_tsv_dense": ["--gfa", "{d}/g2.gfa", "--gaf", "{d}/r2.gaf", "-o",
                       "pack-tsv", "-O", "{d}/o.tsv"],
    "pack_tsv_contrib": ["--graph", "{d}/g.gfa", "--gaf", "{d}/r.gaf", "-o",
                         "pack", "-O", "{d}/sub/o.tsv",
                         "--read-contributions", "{d}/c.tsv"],
    "segment_name": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/r.gaf",
                     "--graph-feature-id-mode", "segment-name", "-O",
                     "{d}/o.proj"],
    "segment_name_bad": ["--gfa", "{d}/g2.gfa", "--gaf", "{d}/r2.gaf",
                         "--graph-feature-id-mode", "segment-name", "-O",
                         "{d}/o.proj"],
    "dense_length_norm": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/r.gaf",
                          "--graph-feature-id-mode", "dense",
                          "--graph-contribution-model", "length-normalized",
                          "-O", "{d}/o.proj"],
    "region_proj": ["--gfa", "{d}/region.gfa", "--gaf", "{d}/m.gaf", "-O",
                    "{d}/o.proj"],
    "region_tsv": ["--gfa", "{d}/region.gfa", "--gaf", "{d}/m.gaf", "-o",
                   "pack-tsv", "-O", "{d}/o.tsv", "--read-contributions",
                   "{d}/c.tsv", "--graph-contribution-model",
                   "length-normalized"],
    "proj_with_contrib": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/r.gaf", "-O",
                          "{d}/o.proj", "--read-contributions", "{d}/c.tsv"],
    "bad_format": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/r.gaf", "-o", "bam",
                   "-O", "{d}/o.proj"],
    "unknown_segment": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/bad.gaf", "-O",
                        "{d}/o.proj"],
    "missing_gaf": ["--gfa", "{d}/g.gfa", "--gaf", "{d}/nope.gaf", "-O",
                    "{d}/o.proj"],
}


@pytest.mark.parametrize("case", sorted(PROJECT_CASES))
def test_cli_project_equals_jax(project_dirs, capsys, case):
    import shutil

    for side in ("jax", "port"):
        for f in ("o.proj", "sub"):
            shutil.rmtree(project_dirs / side / f, ignore_errors=True)
        for f in ("o.tsv", "c.tsv"):
            if (project_dirs / side / f).exists():
                (project_dirs / side / f).unlink()
    res = run_both(project_dirs, ["project"] + PROJECT_CASES[case], capsys,
                   outputs=["o.tsv", "c.tsv", "sub/o.tsv"])
    trees = [read_tree(str(project_dirs / side / "o.proj"),
                       str(project_dirs / side)) for side in ("jax", "port")]
    assert res[0] == res[1] and trees[0] == trees[1]
    bad = {"segment_name_bad", "proj_with_contrib", "bad_format",
           "unknown_segment", "missing_gaf"}
    assert res[0][0] == (2 if case in bad else 0)
    if case == "region_proj":
        assert "Projected" in res[0][2] and trees[1]["sample.pack.tsv"]


@pytest.mark.parametrize("walk", [">a<b>c", "a+,b-", "x-", "*", ">a><b",
                                  "chr1", "", ">", "a+,,b-"])
def test_parse_gaf_walk_equals_jax(walk):
    res = []
    for mod in (port_project, jax_project):
        try:
            res.append(mod.parse_gaf_walk(walk, 3))
        except ValueError as e:
            res.append(("ValueError", str(e)))
    assert res[0] == res[1]


@pytest.mark.parametrize("mode", ["auto", "dense", "segment-name"])
def test_feature_ids_and_graph_id_equal_jax(project_dirs, mode):
    from impg_tpu.graph.gfa import Gfa as JaxGfa
    from impg_tpu_torch.graph.gfa import Gfa as PortGfa

    text = (project_dirs / "port" / "region.gfa").read_text()
    pg, jg = PortGfa.parse(text), JaxGfa.parse(text)
    eff = port_project.resolve_feature_id_mode(list(pg.segments), mode)
    assert eff == jax_project.resolve_feature_id_mode(list(jg.segments),
                                                      mode)
    fids = port_project.feature_ids_for(pg, eff)
    assert fids == jax_project.feature_ids_for(jg, eff)
    assert port_project.graph_id_for(pg, eff, fids) == \
        jax_project.graph_id_for(jg, eff, fids)
    lens = {n: len(s) for n, s in pg.segments.items()}
    gaf = str(project_dirs / "port" / "m.gaf")
    got = port_project.project_gaf(gaf, lens, fids)
    want = jax_project.project_gaf(gaf, lens, fids)
    assert vars(got) == vars(want)


def test_load_projection_bundle_equals_jax(project_dirs, capsys):
    d = project_dirs / "port"
    assert port_project.run_project(
        str(d / "g.gfa"), str(d / "r.gaf"), str(d / "lb.proj")) == \
        jax_project.run_project(str(d / "g.gfa"), str(d / "r.gaf"),
                                str(d / "lb.proj"))
    assert port_project.load_projection_bundle(str(d / "lb.proj")) == \
        jax_project.load_projection_bundle(str(d / "lb.proj"))
