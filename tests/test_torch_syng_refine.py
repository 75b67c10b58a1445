"""Chain-end refinement and the `.syngt` query's region outputs in the port
against impg_tpu, on the CPU.

syng/transitive.py's `refine_chain_ends` (tests/test_syng_transitive.py's
crafted cases: an exact core on both strands, a chain whose first anchor
sits far past the region start) and `query_transitive(seq_idx=...)` on
tests/test_syng_transitive.py's panel (four mutated haplotypes of 15 kb,
tests/datagen.py seed 77) give impg_tpu's chains and rows, and the CLI's
`query -a X.syngt` gives impg_tpu.cli's bytes (standard output, standard
error, exit status), raw and `-x`: `-o bed` with sequence files (refined
chain ends), `fasta`, `gfa`, `maf`, `fasta-aln`, `vcf` and `gfa:sort`.
`-o gbwt` (the regional syng index) is not ported and exits 2.  Exact
throughout."""

import contextlib
import dataclasses
import io
import random

import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.syng import transitive as jax_tr
from impg_tpu.syng.index import SyngIndex as JaxSyng
from impg_tpu_torch.io import fasta as port_fasta
from impg_tpu_torch.syng import transitive as port_tr
from impg_tpu_torch.syng.index import SyngIndex as PortSyng
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _rand(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def _chains(chains):
    return [dataclasses.asdict(c) for c in chains]


def _rows(rows):
    return [(r.q_id, r.q_first, r.q_last, r.t_id, r.t_first, r.t_last)
            for r in rows]


def _both_indexes(fa):
    return (PortSyng.build_from_fasta([fa]), JaxSyng.build_from_fasta([fa]),
            port_fasta.UnifiedSequenceIndex.from_files([fa]),
            jax_fasta.UnifiedSequenceIndex.from_files([fa]))


@pytest.fixture(scope="module")
def core_case(tmp_path_factory):
    """A 4 kb core exact on B and reverse complemented on C."""
    rng = random.Random(33)
    core = _rand(rng, 4000)
    b = _rand(rng, 1500) + core + _rand(rng, 1500)
    c = (_rand(rng, 800)
         + jax_fasta.reverse_complement(core.encode()).decode()
         + _rand(rng, 800))
    a = _rand(rng, 500) + core + _rand(rng, 500)
    fa = str(tmp_path_factory.mktemp("refine_core") / "r.fa")
    datagen.write_fasta(fa, {"A": a, "B": b, "C": c})
    return fa, len(core)


@pytest.mark.parametrize("window", ["core", "left_gap", "right_gap"])
def test_refine_chain_ends_equals_jax(core_case, window):
    fa, n = core_case
    port_syng, jax_syng, port_seq, jax_seq = _both_indexes(fa)
    start, end = {"core": (500, 500 + n), "left_gap": (100, 500 + n),
                  "right_gap": (500, 900 + n)}[window]
    got = port_tr.chain_region(port_syng, "A", start, end)
    ref = jax_tr.chain_region(jax_syng, "A", start, end)
    assert _chains(got) == _chains(ref)
    port_tr.refine_chain_ends(port_syng, got, port_seq, "A", start, end)
    jax_tr.refine_chain_ends(jax_syng, ref, jax_seq, "A", start, end)
    assert _chains(got) == _chains(ref)
    by_genome = {c.genome: c for c in got if c.genome != "A"}
    assert by_genome["C"].strand == "-"
    if window == "core":
        # Exact homology: refined bounds within a few bp of the truth.
        assert abs(by_genome["B"].t_start - 1500) <= 2
        assert abs(by_genome["B"].t_end - (1500 + n)) <= 2
        assert abs(by_genome["C"].t_start - 800) <= 2
        assert abs(by_genome["C"].t_end - (800 + n)) <= 2


def test_refine_survives_large_end_gap(tmp_path):
    """A first anchor far past the region start: the query gap is bounded
    to the end window (the aligner's cell cap), as in impg_tpu."""
    rng = random.Random(9)
    shared = _rand(rng, 3000)
    fa = str(tmp_path / "g.fa")
    datagen.write_fasta(fa, {"big": _rand(rng, 40_000) + shared,
                             "small": _rand(rng, 2000) + shared})
    port_syng, jax_syng, port_seq, jax_seq = _both_indexes(fa)
    got = port_tr.query_transitive(port_syng, "big", 0, 43_000, max_depth=1,
                                   seq_idx=port_seq)
    assert _rows(got) == _rows(jax_tr.query_transitive(
        jax_syng, "big", 0, 43_000, max_depth=1, seq_idx=jax_seq))
    small = port_syng.seq_index.get_id("small")
    assert any(r.q_id == small for r in got)


@pytest.fixture(scope="module")
def trans_panel(tmp_path_factory):
    """tests/test_syng_transitive.py's panel (4 haplotypes of 15 kb) with
    its syng index file, written by the port's `syng`."""
    tmp = tmp_path_factory.mktemp("torch_syngrefine")
    _, _, _, seq_data = datagen.mutate_chain_paf(
        random.Random(77), n_seqs=4, seq_len=15_000, return_sequences=True)
    fa = str(tmp / "panel.fa")
    datagen.write_fasta(fa, seq_data)
    prefix = str(tmp / "p")
    assert torch_cli.main(["syng", "-f", fa, "-o", prefix,
                           "--compute-engine", "host"], device="cpu") == 0
    return tmp, fa, prefix + ".syngt"


@pytest.mark.parametrize("max_depth", [1, 2])
def test_query_transitive_refined_equals_jax(trans_panel, max_depth):
    tmp, fa, _ = trans_panel
    port_syng, jax_syng, port_seq, jax_seq = _both_indexes(fa)
    got = port_tr.query_transitive(port_syng, "ref", 2_000, 10_000,
                                   max_depth=max_depth, seq_idx=port_seq)
    ref = jax_tr.query_transitive(jax_syng, "ref", 2_000, 10_000,
                                  max_depth=max_depth, seq_idx=jax_seq)
    assert _rows(got) == _rows(ref)
    assert {port_syng.seq_index.get_name(r.q_id) for r in got[1:]} & \
        {"s0", "s1", "s2"}


def _both(argv, capsys):
    """(status, stdout, stderr) of each CLI on `argv`."""
    res = []
    for main, kw in ((jax_cli.main, {}), (torch_cli.main, {"device": "cpu"})):
        capsys.readouterr()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            try:
                rc = main(argv, **kw)
            except SystemExit as e:
                rc = ("exit", e.code)
        res.append((rc, out.getvalue(), capsys.readouterr().err))
    return res


@pytest.mark.parametrize("walk", ["raw", "x"])
@pytest.mark.parametrize("fmt", ["bed", "fasta", "gfa", "maf", "fasta-aln",
                                 "vcf", "gfa:sort"])
def test_cli_syngt_region_formats_equal_jax(trans_panel, capsys, fmt, walk):
    tmp, fa, syngt = trans_panel
    argv = ["query", "-a", syngt, "-r", "ref:3000-4500", "-d", "100", "-o",
            fmt, "--sequence-files", fa] + (["-x"] if walk == "x" else [])
    ref, got = _both(argv, capsys)
    assert got == ref
    assert ref[0] == 0 and len(ref[1].splitlines()) >= 2


def test_cli_syngt_refined_bed_equals_jax(tmp_path, capsys):
    """tests/test_syng_transitive.py's CLI case: `-x -o bed` with sequence
    files lands B's row on its true core interval, in impg_tpu.cli's
    bytes."""
    rng = random.Random(34)
    core = _rand(rng, 3000)
    fa = str(tmp_path / "p.fa")
    datagen.write_fasta(fa, {"A": _rand(rng, 400) + core,
                             "B": _rand(rng, 900) + core})
    prefix = str(tmp_path / "p")
    assert torch_cli.main(["syng", "-f", fa, "-o", prefix], device="cpu") == 0
    argv = ["query", "-a", prefix + ".syngt", "-r", "A:400-3400", "-d",
            "100", "-x", "-o", "bed", "--sequence-files", fa]
    ref, got = _both(argv, capsys)
    assert got == ref and ref[0] == 0
    b_rows = [ln.split("\t") for ln in got[1].splitlines()
              if ln.startswith("B\t")]
    s, e = int(b_rows[0][1]), int(b_rows[0][2])
    assert abs(s - 900) <= 5 and abs(e - 3900) <= 5, (s, e)


@pytest.mark.parametrize("argv", [
    ["-o", "gfa"],
    ["-o", "gfa:"],
    ["-o", "bogus"],
], ids=["no_sequences", "empty_stage", "bad_format"])
def test_cli_syngt_errors_equal_jax(trans_panel, capsys, argv):
    tmp, fa, syngt = trans_panel
    ref, got = _both(["query", "-a", syngt, "-r", "ref:0-100", "-d", "10",
                      *argv], capsys)
    assert got == ref and ref[0] != 0


def test_cli_syngt_gbwt_exits_2(trans_panel, capsys):
    """The regional syng index (`-o gbwt` of a `.syngt` query, chained with
    sequence files refining the chain ends) was refused until the port took
    it: now its status and stderr equal impg_tpu.cli's, and each writes a
    `.syngt` of the same arrays (member bytes; the zip carries times)."""
    import zipfile

    tmp, fa, syngt = trans_panel
    res, members = [], []
    for side, (main, kw) in zip(("jax", "port"), (
            (jax_cli.main, {}), (torch_cli.main, {"device": "cpu"}))):
        prefix = str(tmp / f"g_{side}")
        capsys.readouterr()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(["query", "-a", syngt, "-r", "ref:2000-6000", "-d",
                       "100", "-x", "-o", "gbwt", "-O", prefix,
                       "--sequence-files", fa], **kw)
        res.append((rc, out.getvalue(),
                    capsys.readouterr().err.replace(prefix, "<prefix>")))
        with zipfile.ZipFile(prefix + ".syngt") as z:
            members.append({n: z.read(n) for n in sorted(z.namelist())})
    assert res[0] == res[1] and res[0][0] == 0
    assert "Wrote region syng index" in res[0][2]
    assert members[0] == members[1]