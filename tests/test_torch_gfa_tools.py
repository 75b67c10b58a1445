"""The port's GFA toolbox, part one, against impg_tpu on the CPU.

graph/gfa.py's `report` and `report_text` (md, json, tsv), graph/
gfa_columns.py's `report_columns` (held equal to the dict-model `report`
of both packages, as tests/test_gfa_utils.py holds impg_tpu's, on a
seeded fuzz of malformed and well-formed GFAs and on region graphs),
graph/vcf.py's `gfa_to_vcf_flubbles`, graph/render_svg.py's `render_svg`
and io/agz.py's `create_agz` (archives byte for byte: zlib blocks and a
JSON directory, no time field).  Then the commands over them and over the
post-processing modules: `normalize`, `normalize-self-loops` (with
`--diagnose`), `smooth` (`--block-len`, `-G` passes, flubble blocks),
`crush` (its stderr line), `gfa2vcf` (both `--sites`, a repeated `-r`),
`graph-report` (md, json, tsv, `--flubbles`), `render-graph` and `agz
create|list`: exit status, stdout, stderr and every output file equal to
impg_tpu.cli's on the same inputs.  The inputs are impg_tpu's seqwish and
POA graphs of one 1.5 kb window of `synth.panel_alignments(seed=7)` cut
to 8 haplotypes of 12 kb, a tandem repeat and tests/test_bubbles.py's
nested bubbles.  Exact throughout."""

import contextlib
import gzip
import io
import os
import random
import sys
import zipfile

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.graph import gfa as jax_gfa
from impg_tpu.graph import gfa_columns as jax_columns
from impg_tpu.graph import region as jax_region
from impg_tpu.graph import render_svg as jax_svg
from impg_tpu.graph import vcf as jax_vcf
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import agz as jax_agz
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.query import engine as jax_engine
from impg_tpu_torch import synth
from impg_tpu_torch.graph import gfa as port_gfa
from impg_tpu_torch.graph import gfa_columns as port_columns
from impg_tpu_torch.graph import render_svg as port_svg
from impg_tpu_torch.graph import vcf as port_vcf
from impg_tpu_torch.io import agz as port_agz
from tests.test_bubbles import NESTED_GFA
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

TANDEM = (
    "H\tVN:Z:1.0\n"
    "S\t1\tAAGG\n"
    "S\t2\tCAT\n"
    "S\t3\tTTTT\n"
    "L\t1\t+\t2\t+\t0M\n"
    "L\t2\t+\t2\t+\t0M\n"
    "L\t2\t+\t3\t+\t0M\n"
    "P\tx:0-17\t1+,2+,2+,2+,3+\t*\n"
    "P\ty:0-10\t1+,2+,3+\t*\n"
    "P\tz:0-20\t3-,2-,2-,2-,2-,1-\t*\n"
)

GRAPHS = ["seqwish", "poa", "tandem", "nested"]


def panel_files(tmp):
    """The cut panel's FASTA and PAF in `tmp`: (sequences, fasta, paf)."""
    seqs, paf = synth.panel_alignments(seed=7, n_haps=8, length=12_000)
    (tmp / "panel.paf").write_text(paf)
    synth.write_fasta(str(tmp / "panel.fa"), seqs)
    return seqs, str(tmp / "panel.fa"), str(tmp / "panel.paf")


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """impg_tpu's seqwish and POA graphs of one window of the panel, the
    tandem repeat and the nested bubbles, by name."""
    tmp = tmp_path_factory.mktemp("gfa_tools_panel")
    _, fa, paf = panel_files(tmp)
    index = jax_index.ImpgIndex.from_paf_files([paf])
    seq_idx = jax_fasta.UnifiedSequenceIndex.from_files([fa])
    rid = index.seq_index.get_id("base")
    walk = list(jax_engine.query_transitive_bfs_many(
        index, [(rid, 3000, 4500)], max_depth=2)[0])
    return {
        "seqwish": jax_region.generate_gfa_seqwish(index, walk, seq_idx),
        "poa": jax_region.generate_gfa(index, walk, seq_idx),
        "tandem": TANDEM,
        "nested": NESTED_GFA,
    }


# ---- running both command lines ------------------------------------------


def read_output(path: str):
    """An output file's content for comparison: numpy zips by their
    members' bytes, gzip by its text, the rest by bytes (None if absent)."""
    if not os.path.exists(path):
        return None
    if path.endswith((".npz", ".syngt")):
        with zipfile.ZipFile(path) as z:
            return {n: z.read(n) for n in sorted(z.namelist())}
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as fh:
            return fh.read()
    with open(path, "rb") as fh:
        return fh.read()


def run_both(tmp, argv, capsys, outputs=(), stdin=None):
    """Run `argv` through impg_tpu.cli in `tmp`/jax and the port's CLI on
    the CPU in `tmp`/port, `{d}` standing for the side's directory:
    (status, stdout, stderr, {output: content}) for each side, the
    directory written as <d>."""
    res = []
    for side, main, kw in (("jax", jax_cli.main, {}),
                           ("port", torch_cli.main, {"device": "cpu"})):
        d = str(tmp / side)
        capsys.readouterr()
        out = io.StringIO()
        saved = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        try:
            with contextlib.redirect_stdout(out):
                rc = main([a.format(d=d) for a in argv], **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
        finally:
            sys.stdin = saved
        err = capsys.readouterr().err
        files = {o: read_output(os.path.join(d, o)) for o in outputs}
        res.append((rc, out.getvalue().replace(d, "<d>"),
                    err.replace(d, "<d>"), files))
    return res


def side_dirs(tmp, files: dict):
    """`tmp`/jax and `tmp`/port, each holding `files` (name: text)."""
    for side in ("jax", "port"):
        (tmp / side).mkdir(exist_ok=True)
        for name, text in files.items():
            (tmp / side / name).write_text(text)


@pytest.fixture(scope="module")
def graph_dirs(graphs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gfa_tools_cli")
    side_dirs(tmp, {f"{k}.gfa": v for k, v in graphs.items()})
    return tmp


# ---- graph/gfa.py report, graph/gfa_columns.py report_columns ----------


@pytest.mark.parametrize("name", GRAPHS)
def test_report_equals_jax(graphs, name):
    text = graphs[name]
    rep = port_gfa.report(port_gfa.Gfa.parse(text))
    assert rep == jax_gfa.report(jax_gfa.Gfa.parse(text))
    for fmt in ("md", "json", "tsv"):
        assert port_gfa.report_text(rep, fmt) == jax_gfa.report_text(rep,
                                                                     fmt)
    cols = port_columns.report_columns(port_columns.parse_gfa_columns(text))
    assert cols == rep
    assert cols == jax_columns.report_columns(
        jax_columns.parse_gfa_columns(text))


def _fuzz_gfa(trial: int) -> str:
    """tests/test_gfa_utils.py's fuzz: random S/L/P/W lines, dangling
    names, malformed lines, shuffled."""
    rng = random.Random(23 * 1000 + trial)
    lines = []
    if rng.random() < 0.8:
        lines.append("H\tVN:Z:1.0")
    n = rng.randint(0, 30)
    for i in range(1, n + 1):
        name = str(i) if rng.random() < 0.7 else f"node{i}"
        seq = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 12)))
        lines.append(f"S\t{name}\t{seq}")
    for _ in range(rng.randint(0, 30)):
        a, b = rng.randint(1, n + 3), rng.randint(1, n + 3)
        lines.append(f"L\t{a}\t{rng.choice('+-')}\t{b}\t{rng.choice('+-')}"
                     "\t0M")
    for pi in range(rng.randint(0, 6)):
        steps = ",".join(f"{rng.randint(1, n + 2)}{rng.choice('+-')}"
                         for _ in range(rng.randint(0, 20)))
        lines.append(f"P\tp{pi}\t{steps}\t*")
    for wi in range(rng.randint(0, 2)):
        walk = "".join(f"{rng.choice('><')}{rng.randint(1, n + 2)}"
                       for _ in range(rng.randint(0, 8)))
        lines.append(f"W\ts{wi}\t1\tchr1\t0\t100\t{walk}")
    for _ in range(rng.randint(0, 3)):
        lines.append(rng.choice(["S\tonly", "L\t1\t+\t2\t-", "# c", "",
                                 "X\tz", "P\tnm"]))
    if rng.random() < 0.3:  # duplicate S names: the oracle's route
        lines.append("S\t1\tGATTACA")
    rng.shuffle(lines)
    return "\n".join(lines) + ("\n" if rng.random() < 0.7 else "")


@pytest.mark.parametrize("trial", range(20))
def test_report_columns_equals_report(trial):
    """`report_columns(gc) == report(Gfa)` in the port, and both equal
    impg_tpu's, on the fuzz (tests/test_gfa_utils.py:510's check)."""
    text = _fuzz_gfa(trial)
    gc = port_columns.parse_gfa_columns(text)
    rep = port_columns.report_columns(gc)
    assert rep == port_gfa.report(port_gfa.Gfa.parse_python(text))
    assert rep == port_gfa.report(gc.to_gfa())
    assert rep == jax_gfa.report(jax_gfa.Gfa.parse_python(text))
    for fmt in ("md", "json", "tsv"):
        assert port_gfa.report_text(rep, fmt) == jax_gfa.report_text(rep,
                                                                     fmt)


def test_report_columns_non_ascii_and_duplicates():
    text = (
        "H\tVN:Z:1.0\n"
        "S\tnodé\tACGT\n"
        "S\tzz\tGG\n"
        "S\tdup\tAAAA\n"
        "S\tdup\tCC\n"
        "L\tnodé\t+\tzz\t+\t0M\n"
        "P\tp\tnodé+,zz+,dup-\t*\n"
    )
    rep = port_columns.report_columns(port_columns.parse_gfa_columns(text))
    assert rep == port_gfa.report(port_gfa.Gfa.parse_python(text))
    assert rep == jax_gfa.report(jax_gfa.Gfa.parse_python(text))


# ---- gfa_to_vcf_flubbles, render_svg ---------------------------------------


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("ref", [None, "first", "missing"])
def test_gfa_to_vcf_flubbles_equals_jax(graphs, name, ref):
    text = graphs[name]
    if ref == "first":
        ref = jax_gfa.Gfa.parse(text).paths[-1][0]
    res = []
    for fn in (port_vcf.gfa_to_vcf_flubbles, jax_vcf.gfa_to_vcf_flubbles):
        try:
            res.append(fn(text, ref))
        except (ValueError, KeyError) as e:
            res.append((type(e).__name__, str(e)))
    assert res[0] == res[1]


def test_gfa_to_vcf_flubbles_pathless():
    text = "H\tVN:Z:1.0\nS\t1\tACGT\n"
    assert port_vcf.gfa_to_vcf_flubbles(text) == \
        jax_vcf.gfa_to_vcf_flubbles(text)


@pytest.mark.parametrize("name", GRAPHS)
@pytest.mark.parametrize("width", [1200, 300])
def test_render_svg_equals_jax(graphs, name, width):
    text = graphs[name]
    svg = port_svg.render_svg(text, width=width)
    assert svg == jax_svg.render_svg(text, width=width)
    assert svg.startswith("<svg") and "</svg>" in svg


# ---- io/agz.py create_agz ---------------------------------------------------


def _write_samples(d, seed=52):
    """Two sample FASTAs (one gzipped) of a few contigs in `d`."""
    rng = random.Random(seed)
    paths = []
    for sample, n in (("sampleA", 3), ("sampleB", 2)):
        recs = "".join(
            f">chr{i} desc\n"
            + "".join(rng.choice("ACGTN") for _ in range(rng.randint(0, 9000)))
            + "\n" for i in range(n))
        p = d / f"{sample}.fa"
        p.write_text(recs)
        paths.append(str(p))
    with open(paths[1], "rb") as src, gzip.open(paths[1] + ".gz", "wb") as dst:
        dst.write(src.read())
    return [paths[0], paths[1] + ".gz"]


@pytest.mark.parametrize("block_raw", [port_agz.BLOCK_RAW, 1000])
def test_create_agz_bytes_equal_jax(tmp_path, block_raw):
    fastas = _write_samples(tmp_path)
    res = []
    for mod, out in ((port_agz, "port.agz"), (jax_agz, "jax.agz")):
        stats = mod.create_agz(str(tmp_path / out), fastas,
                               block_raw=block_raw)
        res.append((stats, (tmp_path / out).read_bytes()))
    assert res[0] == res[1]
    arc = port_agz.AgzArchive(str(tmp_path / "port.agz"))
    try:
        assert arc.list_samples() == ["sampleA", "sampleB"]
    finally:
        arc.close()


@pytest.mark.parametrize("case", ["dup_stem", "dup_contig", "n_names"])
def test_create_agz_errors_equal_jax(tmp_path, case):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "a" / "s.fa").write_text(">c\nACGT\n")
    (tmp_path / "b" / "s.fa").write_text(
        ">c x\nACGT\n>c y\nGG\n" if case == "dup_contig" else ">d\nAC\n")
    files = [str(tmp_path / "a" / "s.fa"), str(tmp_path / "b" / "s.fa")]
    kw = {}
    if case == "dup_contig":
        files, kw = files[1:], {}
    elif case == "n_names":
        kw = {"sample_names": ["only"]}
    res = []
    for mod in (port_agz, jax_agz):
        with pytest.raises(ValueError) as exc:
            mod.create_agz(str(tmp_path / "x.agz"), files, **kw)
        res.append(str(exc.value))
    assert res[0] == res[1]


# ---- the commands --------------------------------------------------------

CLI_CASES = {
    "normalize": ["normalize", "{d}/seqwish.gfa"],
    "normalize_poa_out": ["normalize", "{d}/poa.gfa", "--output",
                          "{d}/out.gfa"],
    "nsl": ["normalize-self-loops", "{d}/tandem.gfa"],
    "nsl_diagnose": ["normalize-self-loops", "{d}/tandem.gfa",
                     "--diagnose"],
    "nsl_unit_out": ["normalize-self-loops", "{d}/seqwish.gfa",
                     "--max-unit-len", "2", "--output", "{d}/out.gfa"],
    "nsl_diagnose_region": ["normalize-self-loops", "{d}/poa.gfa",
                            "--diagnose"],
    "smooth_block": ["smooth", "{d}/seqwish.gfa", "--block-len", "400"],
    "smooth_passes": ["smooth", "{d}/seqwish.gfa", "-G", "700,1100",
                      "--n-haps", "4", "--max-node-length", "100",
                      "--output", "{d}/out.gfa"],
    "smooth_flubble": ["smooth", "{d}/nested.gfa", "--block-source",
                       "flubble", "--block-len", "8",
                       "--poa-scoring", "1/4/6/2/26/1"],
    "crush": ["crush", "{d}/poa.gfa"],
    "crush_opts": ["crush", "{d}/seqwish.gfa", "--max-span", "500",
                   "--max-rounds", "1", "--output", "{d}/out.gfa"],
    "crush_nested": ["crush", "{d}/nested.gfa"],
    "gfa2vcf": ["gfa2vcf", "{d}/seqwish.gfa"],
    "gfa2vcf_flubbles": ["gfa2vcf", "{d}/poa.gfa", "--sites", "flubbles"],
    "gfa2vcf_refs": ["gfa2vcf", "{d}/seqwish.gfa", "-r", "f0", "-r",
                     "base"],
    "gfa2vcf_flubbles_refs": ["gfa2vcf", "{d}/nested.gfa", "--sites",
                              "flubbles", "-r", "ref", "-r", "ref"],
    "report_md": ["graph-report", "{d}/seqwish.gfa"],
    "report_json": ["graph-report", "{d}/poa.gfa", "--format", "json"],
    "report_tsv": ["graph-report", "{d}/tandem.gfa", "--format", "tsv"],
    "report_flubbles": ["graph-report", "{d}/nested.gfa", "--flubbles",
                        "--reference", "ref"],
    "report_flubbles_json": ["graph-report", "{d}/seqwish.gfa",
                             "--flubbles", "--format", "json"],
    "report_flubbles_tsv": ["graph-report", "{d}/poa.gfa", "--flubbles",
                            "--format", "tsv", "--reference", "f1,base"],
    "report_flubbles_top": ["graph-report", "{d}/seqwish.gfa",
                            "--flubbles", "--top-sites", "2"],
    "render_graph": ["render-graph", "{d}/poa.gfa"],
    "render_graph_out": ["render-graph", "{d}/seqwish.gfa", "--output",
                         "{d}/out.svg", "--width", "600"],
    "missing_input": ["normalize", "{d}/nope.gfa"],
    "missing_report": ["graph-report", "{d}/nope.gfa"],
    "missing_crush": ["crush", "{d}/nope.gfa"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_equals_jax(graph_dirs, capsys, case):
    argv = CLI_CASES[case]
    res = run_both(graph_dirs, argv, capsys,
                   outputs=["out.gfa", "out.svg"])
    assert res[0] == res[1]
    if case.startswith("missing"):
        assert res[0][0] == 1
    else:
        assert res[0][0] == 0
    for f in ("out.gfa", "out.svg"):  # fresh for the next case
        for side in ("jax", "port"):
            p = graph_dirs / side / f
            if p.exists():
                p.unlink()


@pytest.mark.parametrize("argv", [
    ["normalize", "-"], ["graph-report", "-", "--format", "json"],
    ["gfa2vcf", "-", "--sites", "flubbles"], ["render-graph", "-"],
    ["crush", "-"], ["normalize-self-loops", "-"],
    ["smooth", "-", "--block-len", "300"],
], ids=lambda a: a[0])
def test_cli_stdin_equals_jax(graphs, tmp_path, capsys, argv):
    side_dirs(tmp_path, {})
    res = run_both(tmp_path, argv, capsys, stdin=graphs["seqwish"])
    assert res[0] == res[1] and res[0][0] == 0


def test_cli_graph_report_columns_equals_dict_report(graph_dirs, capsys):
    """`graph-report --format json` on the columns equals the dict-model
    report's text."""
    import json

    res = run_both(graph_dirs, ["graph-report", "{d}/seqwish.gfa",
                                "--format", "json"], capsys)
    text = (graph_dirs / "port" / "seqwish.gfa").read_text()
    assert json.loads(res[1][1]) == port_gfa.report(port_gfa.Gfa.parse(text))


@pytest.fixture()
def agz_dirs(tmp_path):
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        _write_samples(tmp_path / side)
        (tmp_path / side / "dup").mkdir()
        (tmp_path / side / "dup" / "sampleA.fa").write_text(">z\nAC\n")
    return tmp_path


@pytest.mark.parametrize("case", [
    ["agz", "create", "{d}/sampleA.fa", "{d}/sampleB.fa.gz", "-o",
     "{d}/out.agz"],
    ["agz", "create", "{d}/sampleA.fa"],
    ["agz", "create", "{d}/sampleA.fa", "{d}/dup/sampleA.fa", "-o",
     "{d}/out.agz"],
    ["agz", "create", "{d}/nope.fa", "-o", "{d}/out.agz"],
    ["agz", "list", "{d}/nope.agz"],
], ids=["create", "no_output", "dup_stem", "missing", "list_missing"])
def test_cli_agz_equals_jax(agz_dirs, capsys, case):
    res = run_both(agz_dirs, case, capsys, outputs=["out.agz"])
    assert res[0] == res[1]
    if "-o" in case and "dup" not in case[3] and "nope" not in case[2]:
        assert res[0][0] == 0 and res[0][3]["out.agz"]


def test_cli_agz_list_and_round_trip(agz_dirs, capsys):
    """`agz list` of an archive (each package's own) prints impg_tpu's
    rows, and a query's sequences fetched through it equal the FASTA's."""
    res = run_both(agz_dirs, ["agz", "create", "{d}/sampleA.fa",
                              "{d}/sampleB.fa.gz", "-o", "{d}/s.agz"],
                   capsys, outputs=["s.agz"])
    assert res[0] == res[1] and res[0][0] == 0
    res = run_both(agz_dirs, ["agz", "list", "{d}/s.agz", "{d}/s.agz"],
                   capsys)
    assert res[0] == res[1] and res[0][0] == 0
    rows = [l.split("\t") for l in res[0][1].splitlines()]
    assert [r[:2] for r in rows[:5]] == [
        ["sampleA", "chr0"], ["sampleA", "chr1"], ["sampleA", "chr2"],
        ["sampleB", "chr0"], ["sampleB", "chr1"]]
    arc = port_agz.AgzArchive(str(agz_dirs / "port" / "s.agz"))
    fa = jax_fasta.FastaIndex.build_from_files(
        [str(agz_dirs / "port" / "sampleA.fa")])
    try:
        for contig in ("chr0", "chr1", "chr2"):
            n = fa.get_sequence_length(contig)
            assert arc.get_sequence_length(f"{contig}@sampleA") == n
            assert arc.fetch_sequence(f"{contig}@sampleA", 0, n) == \
                fa.fetch_sequence(contig, 0, n)
    finally:
        arc.close()
