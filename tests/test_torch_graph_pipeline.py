"""The port's GFA post-processing stages and `-o gfa:<pipeline>` against
impg_tpu's, on the CPU.

graph/pipeline.py's `GraphPipelineSpec.parse` (stages, parameters, inline
values, every error text); graph/gfa.py's `topological_sort` and
`chop_gfa`; graph/bubbles.py's `decompose_flubbles`; graph/smooth.py's
`smooth_gfa` (fixed and flubble block sources) and `smooth_gfa_passes`;
graph/normalize.py's `normalize_gfa`; graph/pggb.py's `pggb_chain`;
graph/selfloops.py's `normalize_self_loops` and `diagnose`; and
graph/crush.py's `crush_gfa` (the graph and its CrushStats), each on a
seqwish and a POA region graph of one 1.5 kb window (impg_tpu's graphs,
so each stage sees the same input), and the self-loop stage on a tandem
repeat too.  The CLI's `query -o gfa:<stages>` gives impg_tpu.cli's bytes,
standard error included (crush's and cut-n's lines), for every stage, over
a panel whose sequences carry N runs at the window's ends, on the port's
host, native and device (the kernels' plain twins) engines, and its
pipeline errors exit 2 with impg_tpu.cli's messages.  The panel is
`synth.panel_alignments(seed=7)` cut to 8 haplotypes of 12 kb.  Exact
throughout."""

import contextlib
import dataclasses
import io

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.graph import bubbles as jax_bubbles
from impg_tpu.graph import crush as jax_crush
from impg_tpu.graph import gfa as jax_gfa
from impg_tpu.graph import normalize as jax_normalize
from impg_tpu.graph import pggb as jax_pggb
from impg_tpu.graph import pipeline as jax_pipeline
from impg_tpu.graph import region as jax_region
from impg_tpu.graph import selfloops as jax_selfloops
from impg_tpu.graph import smooth as jax_smooth
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.query import engine as jax_engine
from impg_tpu_torch import synth
from impg_tpu_torch.graph import bubbles as port_bubbles
from impg_tpu_torch.graph import crush as port_crush
from impg_tpu_torch.graph import gfa as port_gfa
from impg_tpu_torch.graph import normalize as port_normalize
from impg_tpu_torch.graph import pggb as port_pggb
from impg_tpu_torch.graph import pipeline as port_pipeline
from impg_tpu_torch.graph import selfloops as port_selfloops
from impg_tpu_torch.graph import smooth as port_smooth
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

SPECS = [
    "gfa", "gfa:sort", "GFA:Sort:SGD,Pipeline=Ygs",
    "gfa:cut-n=100:sort:sgd:smooth,block-len=900:normalize:crush:selfloops",
    "gfa:smooth,block_source=flubble,block-len=700", "gfa:cut-n=",
    "gfa:crush,max-span=5000:self_loops,max-unit-len=8", " gfa : sort ",
    # errors
    "", "  ", "gfa::sort", "gfa:", ":gfa", "gfa:,x=1", "gfa:=3",
    "gfa:sort,", "gfa:sort,flag", "gfa:sort,=v", "gfa:sort,k=",
    "gfa:sort,k=1,K=2",
]


@pytest.mark.parametrize("spec", SPECS)
def test_pipeline_spec_parse_equals_jax(spec):
    res = []
    for mod in (port_pipeline, jax_pipeline):
        try:
            p = mod.GraphPipelineSpec.parse(spec)
        except ValueError as e:
            res.append(("error", str(e)))
            continue
        res.append((p.to_spec(), p.stages_from(1).to_spec(),
                    [(s.name, s.params, s.value) for s in p.stages],
                    [s.param("block-len") for s in p.stages]))
    assert res[0] == res[1]


# ---- the stages on region graphs ------------------------------------------


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """The panel's files, and impg_tpu's seqwish and POA graphs of one
    window."""
    seqs, paf = synth.panel_alignments(seed=7, n_haps=8, length=12_000)
    tmp = tmp_path_factory.mktemp("pipeline_panel")
    (tmp / "panel.paf").write_text(paf)
    synth.write_fasta(str(tmp / "panel.fa"), seqs)
    # The same panel with N runs at both ends of the window on base and on
    # two founders (cut-n clips them), and a short run cut-n keeps.
    n_seqs = []
    for name, seq in seqs:
        s = bytearray(seq)
        if name in ("base", "f0", "f3"):
            s[2950:3130] = b"N" * 180
            s[4400:4560] = b"N" * 160
        if name == "f1":
            s[2990:3040] = b"n" * 50
        n_seqs.append((name, bytes(s)))
    synth.write_fasta(str(tmp / "panel_n.fa"), n_seqs)
    index = jax_index.ImpgIndex.from_paf_files([str(tmp / "panel.paf")])
    seq_idx = jax_fasta.UnifiedSequenceIndex.from_files(
        [str(tmp / "panel.fa")])
    rid = index.seq_index.get_id("base")
    walk = jax_engine.query_transitive_bfs_many(
        index, [(rid, 3000, 4500)], max_depth=2)[0]
    graphs = {
        "seqwish": jax_region.generate_gfa_seqwish(index, list(walk),
                                                   seq_idx),
        "poa": jax_region.generate_gfa(index, list(walk), seq_idx),
    }
    return tmp, graphs


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

GRAPHS = ["seqwish", "poa"]


def _outcome(fn, *args, **kw):
    """`fn`'s result, or its ValueError's type and text."""
    try:
        return fn(*args, **kw)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("graph", GRAPHS)
def test_topological_sort_and_chop_equal_jax(panel, graph):
    text = panel[1][graph]
    got = port_gfa.topological_sort(port_gfa.Gfa.parse(text)).write()
    assert got == jax_gfa.topological_sort(jax_gfa.Gfa.parse(text)).write()
    assert got != text
    for max_len in (0, 7, 100):
        got = port_gfa.chop_gfa(port_gfa.Gfa.parse(text), max_len).write()
        assert got == jax_gfa.chop_gfa(jax_gfa.Gfa.parse(text),
                                       max_len).write()
    keys = ["12", "3", "n7", "", "-1"]
    assert sorted(keys, key=port_gfa._numeric_key) == \
        sorted(keys, key=jax_gfa._numeric_key)


@pytest.mark.parametrize("graph", GRAPHS)
def test_decompose_flubbles_equals_jax(panel, graph):
    text = panel[1][graph]
    third = text.split("\nP\t")[3].split("\t")[0]
    n_sites = 0
    for names in (None, [third], ["nobody", third]):
        got = port_bubbles.decompose_flubbles(text, names)
        ref = jax_bubbles.decompose_flubbles(text, names)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.level_counts() == ref.level_counts()
        assert port_bubbles.architecture_text(got) == \
            jax_bubbles.architecture_text(ref)
        n_sites += len(got.sites)
    # The POA graph's paths start and end apart: no site has two anchors
    # every path passes, in either package.
    assert n_sites if graph == "seqwish" else n_sites == 0
    assert _outcome(port_bubbles.decompose_flubbles, text, ["nobody"]) == \
        _outcome(jax_bubbles.decompose_flubbles, text, ["nobody"])


@pytest.mark.parametrize("source", ["fixed", "flubble"])
@pytest.mark.parametrize("graph", GRAPHS)
def test_smooth_gfa_equals_jax(panel, graph, source):
    text = panel[1][graph]
    kw = dict(block_source=source, n_haps=5, max_node_length=50)
    got = port_smooth.smooth_gfa(text, 400, **kw)
    assert got == jax_smooth.smooth_gfa(text, 400, **kw)
    assert got.count("\nP\t") >= 8


@pytest.mark.parametrize("graph", GRAPHS)
def test_smooth_passes_and_normalize_equal_jax(panel, graph):
    text = panel[1][graph]
    got = port_smooth.smooth_gfa_passes(text, (300, 700))
    assert got == jax_smooth.smooth_gfa_passes(text, (300, 700))
    for pre_groom in (True, False):
        assert port_normalize.normalize_gfa(got, pre_groom=pre_groom) == \
            jax_normalize.normalize_gfa(got, pre_groom=pre_groom)


def test_normalize_dict_fallback_equals_jax(panel, monkeypatch):
    """Duplicate S names send normalize to the dict model (with
    sortgfa.groom), in both packages."""
    text = panel[1]["poa"]
    first_s = next(ln for ln in text.splitlines() if ln.startswith("S\t"))
    dup = text.replace(first_s + "\n", first_s + "\n" + first_s + "\n", 1)
    assert port_normalize.normalize_gfa(dup) == \
        jax_normalize.normalize_gfa(dup)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("graph", GRAPHS)
def test_pggb_chain_equals_jax(panel, graph, skip):
    text = panel[1][graph]
    got = port_pggb.pggb_chain(text, skip_normalize=skip)
    assert got == jax_pggb.pggb_chain(text, skip_normalize=skip)
    names = [f"s{i}#{i % 2}#c" for i in range(4)] + ["plain", "x#1"]
    assert port_pggb.count_pansn_haplotypes(names) == \
        jax_pggb.count_pansn_haplotypes(names)


@pytest.mark.parametrize("graph", GRAPHS + ["tandem"])
def test_self_loops_equal_jax(panel, graph):
    text = TANDEM if graph == "tandem" else panel[1][graph]
    assert port_selfloops.diagnose(port_gfa.Gfa.parse(text)) == \
        jax_selfloops.diagnose(jax_gfa.Gfa.parse(text))
    for max_unit in (0, 2):
        got = _outcome(port_selfloops.normalize_self_loops, text, max_unit)
        ref = _outcome(jax_selfloops.normalize_self_loops, text, max_unit)
        if ref[0] == "ValueError":
            assert got == ref
            continue
        assert got[0] == ref[0]
        gst = got[1]
        assert dataclasses.asdict(gst) == dataclasses.asdict(ref[1])
    if graph == "tandem":
        assert gst.collapsed_runs == 0  # max-unit-len 2 < the unit's 3
        _, gst = port_selfloops.normalize_self_loops(text)
        assert gst.collapsed_runs == 2


@pytest.mark.parametrize("graph", GRAPHS)
def test_crush_gfa_equals_jax(panel, graph):
    text = panel[1][graph]
    for kw in ({}, {"max_span": 60, "polish": False}):
        got, gst = port_crush.crush_gfa(text, **kw)
        ref, rst = jax_crush.crush_gfa(text, **kw)
        assert got == ref
        assert dataclasses.asdict(gst) == dataclasses.asdict(rst)


# ---- the CLI ---------------------------------------------------------------


def _run(main, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv, **kw)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, out.getvalue(), err.getvalue()


STAGES = {
    "sort": "gfa:sort",
    "sgd": "gfa:sgd",
    "sgd_pipeline": "gfa:sgd,pipeline=gs",
    "smooth": "gfa:smooth,block-len=500",
    "smooth_flubble": "gfa:smooth,block-source=flubble",
    "normalize": "gfa:normalize",
    "crush": "gfa:crush",
    "crush_span": "gfa:crush,max-span=80",
    "selfloops": "gfa:selfloops",
    "self_loops_unit": "gfa:self-loops,max-unit-len=4",
    "cut_n": "gfa:cut-n=100",
    "cut_n_param": "gfa:cut-n,min-run=40:sort",
    "all": "gfa:cut-n=100:sort:sgd:smooth,block-len=900:normalize:crush:"
           "selfloops",
}


@pytest.mark.parametrize("engine", ["host", "native", "device"])
@pytest.mark.parametrize("stages", list(STAGES))
def test_query_gfa_pipeline_cli_matches_jax(panel, stages, engine):
    tmp, _ = panel
    argv = ["query", "-a", f"{tmp}/panel.paf", "-r", "base:3000-4500", "-x",
            "-m", "2", "-d", "0", "--sequence-files", f"{tmp}/panel_n.fa",
            "-o", STAGES[stages], "--compute-engine"]
    got = _run(torch_cli.main, argv + [engine], device="cpu")
    ref = _run(jax_cli.main, argv + ["native" if engine == "native"
                                     else "host"])
    assert got == ref
    assert ref[0] == 0 and ref[1].count("\nP\t") >= 8
    if "cut-n" in STAGES[stages]:
        line = ref[2].splitlines()[0]
        assert line.startswith("terminal N clipping: min-run=")
        kept = line.split(", ")[1].split(" -> ")
        assert int(kept[0]) > int(kept[1].split()[0])
    if "crush" in STAGES[stages]:
        assert ref[2].splitlines()[-1].startswith("crush: ")


@pytest.mark.parametrize("engine", ["seqwish", "pggb", "syng-native"])
def test_query_gfa_pipeline_over_seqwish_engines(panel, engine):
    tmp, _ = panel
    argv = ["query", "-a", f"{tmp}/panel.paf", "-r", "base:3000-4500", "-x",
            "-m", "2", "-d", "0", "--sequence-files", f"{tmp}/panel.fa",
            "-o", "gfa:sgd:crush", "--gfa-engine", engine]
    got = _run(torch_cli.main, argv + ["--compute-engine", "device"],
               device="cpu")
    ref = _run(jax_cli.main, argv + ["--compute-engine", "host"])
    assert got == ref and ref[0] == 0


@pytest.mark.parametrize("spec", ["gfa:poa", "gfa:sort,k", "gfa::sort",
                                  "gfa:", "gfa:sort:bogus,x=1"])
def test_query_gfa_pipeline_errors_match_jax(panel, spec):
    tmp, _ = panel
    argv = ["query", "-a", f"{tmp}/panel.paf", "-r", "base:3000-4500", "-d",
            "0", "--sequence-files", f"{tmp}/panel.fa", "-o", spec]
    got = _run(torch_cli.main, argv, device="cpu")
    ref = _run(jax_cli.main, argv)
    assert got == ref and ref[0] == 2 and ref[2].startswith("error: ")
