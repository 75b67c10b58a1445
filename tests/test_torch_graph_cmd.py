"""The port's GFA toolbox, part two, against impg_tpu on the CPU: `lace`,
`align` and `graph`.

graph/lace.py's `lace_files` and graph/vcf_lace.py's `lace_vcfs` by value;
then each command's exit status, stdout, stderr and output files equal to
impg_tpu.cli's on the same seeded inputs (tests/test_lace.py's windows,
tests/test_graph_cmd.py's and tests/test_align.py's FASTAs):

  * `lace` of GFAs and VCFs, listed the four ways (`--gfa-files`,
    `--files`, `--gfa-list`, `--file-list`), with `--fill-gaps` and
    `--sequence-files` or `--sequence-list`, gzipped inputs, and `.gz`
    (compared by its text: gzip carries a time) and `.zst` outputs;
  * `align`: all pairs, `--pair`, `--sparsify`, `--job-list` (the one
    deliberate divergence: its commands run `python -m impg_tpu_torch.cli`,
    where impg_tpu's run `python -m impg_tpu.cli`; with the module name
    replaced the bytes are equal) and `--run-joblist`, which runs the
    port's job list in subprocesses (each pair file equal to impg_tpu's
    `--pair` run);
  * `graph --gfa-engine poa|seqwish|pggb`, `-a` with `align`'s PAF (equal
    to the graph that aligns the same pairs itself), `--sparsify`,
    `--partition-size` through the port's own `partition -o gfa` on the
    caller's device (here the CPU); `syng-native` exits 2 with impg_tpu's
    message in both; `syng-local`, which impg_tpu.cli accepts and then
    refuses, is not among the port's choices: both exit 2.

The other divergence: without `zstandard`, a `.zst` lace output exits 1
with a precise message, where impg_tpu raises ModuleNotFoundError."""

import os
import re
import shutil
import sys

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.graph import lace as jax_lace
from impg_tpu.graph import vcf_lace as jax_vcf_lace
from impg_tpu.io.fasta import UnifiedSequenceIndex as JaxUSI
from impg_tpu_torch.graph import lace as port_lace
from impg_tpu_torch.graph import vcf_lace as port_vcf_lace
from impg_tpu_torch.io.fasta import UnifiedSequenceIndex as PortUSI
from tests import datagen
from tests.test_fasta import make_fasta
from tests.test_lace import (_window_vcf, index_from_text, path_seqs,
                             region_gfa)
from tests.test_torch_gfa_tools import run_both
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _zst_text(path: str):
    if not os.path.exists(path):
        return None
    import zstandard

    with open(path, "rb") as fh:
        return zstandard.ZstdDecompressor().decompress(fh.read())


# ---- lace -----------------------------------------------------------------


@pytest.fixture(scope="module")
def lace_dirs(tmp_path_factory):
    """Each side's directory: four window GFAs of one panel (two that
    overlap, two with a gap between them), one gzipped, window VCFs (one
    gzipped), list files and the panel FASTA."""
    import gzip

    tmp = tmp_path_factory.mktemp("torch_lace")
    src = tmp / "src"
    src.mkdir()
    fa, paf, seqs, seq_data = make_fasta(src, seed=23)
    index = index_from_text(open(paf).read())
    seq_idx = JaxUSI.from_files([fa])
    rid = index.seq_index.get_id("ref")
    files = {
        "w1.gfa": region_gfa(index, seq_idx, rid, 0, 700),
        "w2.gfa": region_gfa(index, seq_idx, rid, 600, 1500),
        "g1.gfa": region_gfa(index, seq_idx, rid, 0, 500),
        "g2.gfa": region_gfa(index, seq_idx, rid, 900, 1400),
    }
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        shutil.copy(fa, d / "seqs.fa")
        for name, text in files.items():
            (d / name).write_text(text)
        with gzip.open(d / "g2.gfa.gz", "wt") as fh:
            fh.write(files["g2.gfa"])
        (d / "gfas.txt").write_text(
            f"# windows\n{d}/w1.gfa\n\n{d}/w2.gfa\n")
        (d / "seqs.txt").write_text(f"{d}/seqs.fa\n")
        _window_vcf(str(d / "v1.vcf"), None, ["sampleA"],
                    [("ref:1000-1400", 5, "A", "T", ["1"])],
                    meta=("##source=impg-tpu-test",))
        _window_vcf(str(d / "v2.vcf"), None, ["sampleB", "sampleA"],
                    [("ref:0-1000", 10, "G", "C", ["0", "1"]),
                     ("a:500-900", 3, "T", "G", ["1", "0"])])
        with open(d / "v1.vcf", "rb") as s, \
                gzip.open(d / "v1.vcf.gz", "wb") as o:
            o.write(s.read())
        (d / "vcfs.txt").write_text(f"{d}/v2.vcf\n{d}/v1.vcf.gz\n")
    return tmp, seq_data


LACE_CASES = {
    "gfa_files": ["--gfa-files", "{d}/w1.gfa,{d}/w2.gfa", "--output",
                  "{d}/out.gfa"],
    "repeat_and_files": ["--gfa-files", "{d}/w2.gfa", "--files",
                         "{d}/w1.gfa", "--output", "{d}/out.gfa"],
    "gfa_list": ["--gfa-list", "{d}/gfas.txt", "--output", "{d}/out.gfa"],
    "file_list_gz": ["--file-list", "{d}/gfas.txt", "--files",
                     "{d}/g2.gfa.gz", "--output", "{d}/out.gfa"],
    "fill_gaps": ["--gfa-files", "{d}/g1.gfa,{d}/g2.gfa.gz", "--fill-gaps",
                  "--sequence-files", "{d}/seqs.fa", "--output",
                  "{d}/out.gfa"],
    "fill_gaps_list": ["--gfa-files", "{d}/g2.gfa", "--gfa-files",
                       "{d}/g1.gfa", "--fill-gaps", "--sequence-list",
                       "{d}/seqs.txt", "--output", "{d}/out.gfa"],
    "gaps_unfilled": ["--gfa-files", "{d}/g1.gfa,{d}/g2.gfa", "--output",
                      "{d}/out.gfa"],
    "fill_gaps_no_seqs": ["--gfa-files", "{d}/g1.gfa,{d}/g2.gfa",
                          "--fill-gaps", "--output", "{d}/out.gfa"],
    "gz_out": ["--gfa-files", "{d}/w1.gfa,{d}/w2.gfa", "--output",
               "{d}/out.gfa.gz"],
    "zst_out": ["--gfa-files", "{d}/w1.gfa,{d}/w2.gfa", "--output",
                "{d}/out.gfa.zst"],
    "vcf_auto": ["--files", "{d}/v1.vcf,{d}/v2.vcf", "--output",
                 "{d}/out.vcf"],
    "vcf_list_gz": ["--file-list", "{d}/vcfs.txt", "--format", "vcf",
                    "--output", "{d}/out.vcf.gz"],
    "vcf_lengths": ["--files", "{d}/v2.vcf", "--files", "{d}/v1.vcf.gz",
                    "--sequence-files", "{d}/seqs.fa", "--output",
                    "{d}/out.vcf"],
    "gfa_forced_on_vcf_names": ["--format", "gfa", "--files",
                                "{d}/w1.gfa", "--output", "{d}/out.vcf"],
    "no_inputs": ["--output", "{d}/out.gfa"],
    "missing": ["--gfa-files", "{d}/nope.gfa", "--output", "{d}/out.gfa"],
    "both_seq_opts": ["--gfa-files", "{d}/w1.gfa", "--sequence-files",
                      "{d}/seqs.fa", "--sequence-list", "{d}/seqs.txt",
                      "--output", "{d}/out.gfa"],
}
LACE_OUTPUTS = ["out.gfa", "out.gfa.gz", "out.vcf", "out.vcf.gz"]


@pytest.mark.parametrize("case", sorted(LACE_CASES))
def test_cli_lace_equals_jax(lace_dirs, capsys, case):
    tmp, seq_data = lace_dirs
    for side in ("jax", "port"):
        for f in LACE_OUTPUTS + ["out.gfa.zst"]:
            if (tmp / side / f).exists():
                (tmp / side / f).unlink()
    res = run_both(tmp, ["lace"] + LACE_CASES[case], capsys,
                   outputs=LACE_OUTPUTS)
    zst = [_zst_text(str(tmp / side / "out.gfa.zst"))
           for side in ("jax", "port")]
    assert res[0] == res[1] and zst[0] == zst[1]
    expect = {"no_inputs": 2, "both_seq_opts": 2, "missing": 1}
    assert res[0][0] == expect.get(case, 0)
    if case.startswith("fill_gaps") and case != "fill_gaps_no_seqs":
        # Laced paths spell the concatenation of their pieces, gaps filled.
        laced = path_seqs(res[1][3]["out.gfa"].decode())
        assert laced["ref:0-1400"] == seq_data["ref"][:1400]
    if case == "zst_out":
        assert zst[1] == res[1][3]["out.gfa"] or zst[1].startswith(b"H\t")


def test_cli_lace_zst_without_zstandard(lace_dirs, capsys, monkeypatch):
    """Where `zstandard` is not installed the port exits 1 with a precise
    message before writing (impg_tpu raises ModuleNotFoundError)."""
    tmp, _ = lace_dirs
    monkeypatch.setitem(sys.modules, "zstandard", None)
    d = str(tmp / "port")
    rc = torch_cli.main(["lace", "--gfa-files", f"{d}/w1.gfa", "--output",
                         f"{d}/none.gfa.zst"], device="cpu")
    err = capsys.readouterr().err
    assert rc == 1
    assert "needs the zstandard package" in err
    assert not os.path.exists(f"{d}/none.gfa.zst")
    with pytest.raises(ModuleNotFoundError):
        jax_cli.main(["lace", "--gfa-files", f"{tmp}/jax/w1.gfa",
                      "--output", f"{tmp}/jax/none.gfa.zst"])


@pytest.mark.parametrize("fill", [False, True])
def test_lace_files_equals_jax(lace_dirs, fill):
    tmp, _ = lace_dirs
    d = tmp / "port"
    files = [str(d / "g2.gfa.gz"), str(d / "g1.gfa"), str(d / "w1.gfa")]
    got = port_lace.lace_files(files, fill, PortUSI.from_files(
        [str(d / "seqs.fa")]))
    assert got == jax_lace.lace_files(files, fill, JaxUSI.from_files(
        [str(d / "seqs.fa")]))


@pytest.mark.parametrize("with_ref", [False, True])
def test_lace_vcfs_equals_jax(lace_dirs, with_ref):
    tmp, _ = lace_dirs
    d = tmp / "port"
    files = [str(d / "v1.vcf.gz"), str(d / "v2.vcf")]
    ref = (PortUSI.from_files([str(d / "seqs.fa")]),
           JaxUSI.from_files([str(d / "seqs.fa")])) if with_ref else (None,
                                                                       None)
    assert port_vcf_lace.lace_vcfs(files, ref[0]) == \
        jax_vcf_lace.lace_vcfs(files, ref[1])
    assert port_vcf_lace.chr_sort_key("chr10") == \
        jax_vcf_lace.chr_sort_key("chr10")


# ---- align ----------------------------------------------------------------


@pytest.fixture(scope="module")
def fasta_dirs(tmp_path_factory):
    """Each side's directory with tests/test_graph_cmd.py's three
    sequences (g.fa), tests/test_align.py's chain (p.fa) and a list."""
    import random

    tmp = tmp_path_factory.mktemp("torch_graph_cmd")
    rng = random.Random(7)
    base = "".join(rng.choice("ACGT") for _ in range(1500))
    seqs = {
        "ref": base,
        "a": base[:500] + "TTTTGGGGCCCC" + base[520:],
        "b": base[:900] + base[950:],
    }
    _, _, _, chain = datagen.mutate_chain_paf(
        random.Random(21), n_seqs=3, seq_len=2000, return_sequences=True)
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        datagen.write_fasta(str(d / "g.fa"), seqs)
        datagen.write_fasta(str(d / "p.fa"), chain)
        (d / "list.txt").write_text(f"{d}/g.fa\n")
    return tmp, seqs, chain


ALIGN_CASES = {
    "all_pairs": ["-f", "{d}/p.fa"],
    "output": ["-f", "{d}/g.fa", "-o", "{d}/out.paf"],
    "two_files": ["-f", "{d}/g.fa", "-f", "{d}/p.fa", "--min-anchors", "5"],
    "pair": ["-f", "{d}/p.fa", "--pair", "ref:s0", "--pair", "s1:ref"],
    "bad_pair": ["-f", "{d}/p.fa", "--pair", "nope"],
    "knn": ["-f", "{d}/p.fa,{d}/g.fa", "--sparsify", "knn:2"],
    "random": ["-f", "{d}/g.fa", "--sparsify", "random:0.5"],
    "bad_sparsify": ["-f", "{d}/g.fa", "--sparsify", "bogus"],
    "scoring": ["-f", "{d}/g.fa", "--scoring", "2,4,4,1", "--max-gap",
                "500", "--min-chain-span", "50"],
    "bad_scoring": ["-f", "{d}/g.fa", "--scoring", "1,4,6"],
    "mash": ["-f", "{d}/p.fa", "--sparsify", "knn:1", "--mash-k", "11",
             "--sketch-size", "200"],
    "missing": ["-f", "{d}/nope.fa"],
}


@pytest.mark.parametrize("case", sorted(ALIGN_CASES))
def test_cli_align_equals_jax(fasta_dirs, capsys, case):
    tmp, _, _ = fasta_dirs
    res = run_both(tmp, ["align"] + ALIGN_CASES[case], capsys,
                   outputs=["out.paf"])
    assert res[0] == res[1]
    expect = {"bad_pair": 2, "bad_scoring": 2, "missing": 1,
              "bad_sparsify": 1}
    assert res[0][0] == expect.get(case, 0)


@pytest.mark.parametrize("extra", [[], ["--pair", "b:a"],
                                   ["--sparsify", "knn:1"],
                                   ["-o", "{d}/jobs.txt"]],
                         ids=["all", "pair", "knn", "output"])
def test_cli_align_job_list_names_the_port(fasta_dirs, capsys, extra):
    """The one deliberate divergence: the port's job lines run
    `python -m impg_tpu_torch.cli`; with impg_tpu's module name replaced
    by it, impg_tpu's output equals the port's byte for byte."""
    tmp, _, _ = fasta_dirs
    res = run_both(tmp, ["align", "-f", "{d}/g.fa", "--job-list"] + extra,
                   capsys, outputs=["jobs.txt"])
    fix = (lambda t: t.replace("python -m impg_tpu.cli ",
                               "python -m impg_tpu_torch.cli "))
    files = [{k: v and v.decode().replace(str(tmp / side), "<d>")
              for k, v in r[3].items()}
             for r, side in zip(res, ("jax", "port"))]
    jax = (res[0][0], fix(res[0][1]), res[0][2],
           {k: v and fix(v) for k, v in files[0].items()})
    assert jax == res[1][:3] + (files[1],) and res[1][0] == 0
    lines = (res[1][1] or files[1]["jobs.txt"]).splitlines()
    assert lines and all(l.startswith("python -m impg_tpu_torch.cli align ")
                         for l in lines)


def _norm_progress(err: str) -> str:
    return re.sub(r"elapsed \d+s eta \d+s", "elapsed Ts eta Ts", err)


def test_cli_run_joblist_status_equals_jax(tmp_path, capsys):
    """`--run-joblist` of shell commands, two of which fail: impg_tpu's
    status and progress lines (its times aside)."""
    side_jobs = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        (d / "jobs.txt").write_text(
            f"# a comment\ntrue\nfalse\n\necho x > {d}/x.txt\nexit 3\n")
        side_jobs.append(d)
    res = run_both(tmp_path, ["align", "-f", "unused.fa", "--run-joblist",
                              "{d}/jobs.txt", "--jobs", "2"], capsys,
                   outputs=["x.txt"])
    res = [(r[0], r[1], _norm_progress(r[2]), r[3]) for r in res]
    assert res[0] == res[1]
    assert res[0][0] == 1 and "(2 failed)" in res[0][2]


def test_cli_run_joblist_runs_the_port(fasta_dirs, capsys, monkeypatch):
    """The port's job list, run by `--run-joblist`, starts the port's CLI
    for every pair: each pair file equals impg_tpu's `--pair` run."""
    tmp, _, _ = fasta_dirs
    d = tmp / "port"
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.chdir(d)
    assert torch_cli.main(["align", "-f", f"{d}/g.fa", "--job-list", "-o",
                           f"{d}/jobs.txt"], device="cpu") == 0
    jobs = (d / "jobs.txt").read_text().splitlines()
    # python on PATH may not be this interpreter: name it.
    (d / "jobs_abs.txt").write_text("".join(
        j.replace("python -m", f"{sys.executable} -m", 1) + "\n"
        for j in jobs))
    assert torch_cli.main(["align", "-f", f"{d}/g.fa", "--run-joblist",
                           f"{d}/jobs_abs.txt", "--jobs", "3"],
                          device="cpu") == 0
    assert "(0 failed)" in capsys.readouterr().err
    j = tmp / "jax"
    for i, line in enumerate(jobs):
        pair = line.split("--pair ")[1].split()[0]
        assert jax_cli.main(["align", "-f", f"{j}/g.fa", "--pair", pair,
                             "-o", f"{j}/pair_{i:05d}.paf"]) == 0
        assert (d / f"pair_{i:05d}.paf").read_bytes() == \
            (j / f"pair_{i:05d}.paf").read_bytes()


# ---- graph ----------------------------------------------------------------

GRAPH_CASES = {
    "seqwish": ["-f", "{d}/g.fa", "--gfa-engine", "seqwish"],
    "default_out": ["--sequence-files", "{d}/g.fa", "-o", "{d}/out.gfa"],
    "poa": ["-f", "{d}/g.fa", "--gfa-engine", "poa", "-g", "{d}/out.gfa"],
    "poa_scoring": ["-f", "{d}/p.fa", "--gfa-engine", "poa",
                    "--poa-scoring", "2/4/4/2/24/1"],
    "pggb": ["-f", "{d}/g.fa", "--gfa-engine", "pggb"],
    "pggb_chain": ["-f", "{d}/p.fa", "--gfa-engine", "pggb", "-o",
                   "{d}/out.gfa"],
    "knn": ["-f", "{d}/g.fa,{d}/p.fa", "--sparsify", "knn:2"],
    "list": ["--sequence-list", "{d}/list.txt", "-o", "-"],
    "partition": ["-f", "{d}/g.fa", "--partition-size", "800", "-d", "100",
                  "-o", "{d}/out.gfa"],
    "partition_stdout": ["-f", "{d}/p.fa", "--partition-size", "1k"],
    "syng_native": ["-f", "{d}/g.fa", "--gfa-engine", "syng-native"],
    "no_files": ["--gfa-engine", "poa"],
    "missing_paf": ["-f", "{d}/g.fa", "-a", "{d}/nope.paf"],
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_cli_graph_equals_jax(fasta_dirs, capsys, case):
    tmp, seqs, chain = fasta_dirs
    for side in ("jax", "port"):
        if (tmp / side / "out.gfa").exists():
            (tmp / side / "out.gfa").unlink()
    res = run_both(tmp, ["graph"] + GRAPH_CASES[case], capsys,
                   outputs=["out.gfa"])
    assert res[0] == res[1]
    expect = {"syng_native": 2, "no_files": 2, "missing_paf": 1}
    assert res[0][0] == expect.get(case, 0)
    argv = " ".join(GRAPH_CASES[case])
    if res[0][0] == 0 and not ("g.fa" in argv and "p.fa" in argv):
        # Every path spells its input (a laced partition path its slice).
        text = res[1][1] or res[1][3]["out.gfa"].decode()
        spelled = path_seqs(text)
        truth = chain if "p.fa" in argv else seqs
        for name, s in spelled.items():
            key, _, rng = name.rpartition(":")
            if key in truth and "-" in rng:  # laced partition paths
                a, b = map(int, rng.split("-"))
                assert s == truth[key][a:b], name
            else:
                assert s == truth[name], name


def test_cli_graph_syng_local_exits_2_in_both(fasta_dirs, capsys):
    """impg_tpu.cli accepts `syng-local` and then refuses it (status 2,
    its message); the port's parser does not offer it (status 2, usage)."""
    tmp, _, _ = fasta_dirs
    res = run_both(tmp, ["graph", "-f", "{d}/g.fa", "--gfa-engine",
                         "syng-local"], capsys)
    assert res[0][0] == 2 and "syng-local is only available" in res[0][2]
    assert res[1][0] == ("exit", 2)
    assert "invalid choice: 'syng-local'" in res[1][2]


def test_cli_graph_given_paf_equals_self_aligned(fasta_dirs, capsys):
    """`graph -a` with `align`'s PAF equals impg_tpu's, and equals the
    graph that aligns the same pairs itself."""
    tmp, _, _ = fasta_dirs
    res = run_both(tmp, ["align", "-f", "{d}/p.fa", "-o", "{d}/aln.paf"],
                   capsys, outputs=["aln.paf"])
    assert res[0] == res[1] and res[0][0] == 0
    for engine in ("seqwish", "pggb"):
        given = run_both(tmp, ["graph", "-f", "{d}/p.fa", "-a",
                               "{d}/aln.paf", "--gfa-engine", engine],
                         capsys)
        assert given[0] == given[1] and given[0][0] == 0
        own = run_both(tmp, ["graph", "-f", "{d}/p.fa", "--gfa-engine",
                             engine], capsys)
        assert own[1][1] == given[1][1]


def test_cli_graph_partition_carries_the_device(fasta_dirs, capsys,
                                                monkeypatch):
    """`--partition-size` re-enters the port's CLI with `partition` on the
    caller's device (never cuda:0 in these tests), with and without a
    given PAF."""
    tmp, _, _ = fasta_dirs
    seen = []
    real = torch_cli.cmd_partition

    def spy(args, device):
        seen.append((args.compute_engine, str(device)))
        return real(args, device)

    monkeypatch.setattr(torch_cli, "cmd_partition", spy)
    assert torch_cli.main(["align", "-f", f"{tmp}/port/p.fa", "-o",
                           f"{tmp}/port/aln.paf"], device="cpu") == 0
    shutil.copy(tmp / "port" / "aln.paf", tmp / "jax" / "aln.paf")
    res = run_both(tmp, ["graph", "-f", "{d}/p.fa", "-a", "{d}/aln.paf",
                         "--partition-size", "700", "-d", "50"], capsys)
    assert res[0] == res[1] and res[0][0] == 0
    assert seen == [("auto", "cpu")]
