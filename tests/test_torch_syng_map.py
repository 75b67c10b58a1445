"""`map -a INDEX -o gaf|paf|proj` and `.syngt` queries in the port against
impg_tpu, on the CPU.

On the panels of tests/test_map_genotype.py (four mutated haplotypes of
12 kb, tests/datagen.py seed 123, 800 reads) and tests/test_syng_transitive.py
(four of 15 kb, seed 77), both packages index the same FASTA: matched
syncmers, GAF and PAF rows, anchor chains and transitive walks are equal,
and the CLI's bytes are equal (`impg_tpu_torch.cli.main(argv, device="cpu")`
against `impg_tpu.cli.main`: standard output, standard error and every
file, the proj bundle's included).  The reference tests' own assertions are
kept.  What stays refused exits 2 before any input is read: a `.syngt`
query's `-o gbwt`, and `.syngt` inputs of `index` and `stats`; a `.syngt`
query with sequence files or a sequence-backed format runs as impg_tpu.cli
does (tests/test_torch_syng_refine.py holds its outputs)."""

import contextlib
import dataclasses
import io
import os
import random

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.io.fasta import reverse_complement
from impg_tpu.syng import map as jax_map
from impg_tpu.syng import transitive as jax_tr
from impg_tpu.syng.index import SyngIndex as JaxSyng
from impg_tpu_torch.syng import map as port_map
from impg_tpu_torch.syng import transitive as port_tr
from impg_tpu_torch.syng.index import SyngIndex as PortSyng
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def simulate_reads(rng, seq: str, n: int, length: int = 150):
    reads = []
    for i in range(n):
        s = rng.randint(0, len(seq) - length)
        reads.append((f"r{i}", seq[s : s + length]))
    return reads


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """tests/test_map_genotype.py's panel: 4 haplotypes, a diploid sample
    of ref + s1; both packages' indexes and the port's syng index file."""
    tmp = tmp_path_factory.mktemp("torch_syngmap")
    rng = random.Random(123)
    _, _, _, seq_data = datagen.mutate_chain_paf(
        rng, n_seqs=4, seq_len=12_000, return_sequences=True
    )
    fa = str(tmp / "panel.fa")
    datagen.write_fasta(fa, seq_data)
    reads = simulate_reads(rng, seq_data["ref"], 400) + simulate_reads(
        rng, seq_data["s1"], 400
    )
    fastq = str(tmp / "reads.fastq")
    with open(fastq, "w") as fh:
        for name, seq in reads:
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
    prefix = str(tmp / "pan")
    assert torch_cli.main(["syng", "-f", fa, "-o", prefix,
                           "--compute-engine", "host"], device="cpu") == 0
    return (tmp, fa, seq_data, fastq, prefix + ".syngt",
            PortSyng.build_from_fasta([fa]), JaxSyng.build_from_fasta([fa]))


@pytest.fixture(scope="module")
def trans_panel(tmp_path_factory):
    """tests/test_syng_transitive.py's panel (4 haplotypes of 15 kb)."""
    tmp = tmp_path_factory.mktemp("torch_syngtrans")
    rng = random.Random(77)
    _, _, _, seq_data = datagen.mutate_chain_paf(
        rng, n_seqs=4, seq_len=15_000, return_sequences=True
    )
    fa = str(tmp / "panel.fa")
    datagen.write_fasta(fa, seq_data)
    prefix = str(tmp / "p")
    assert torch_cli.main(["syng", "-f", fa, "-o", prefix,
                           "--compute-engine", "host"], device="cpu") == 0
    return (tmp, fa, seq_data, prefix + ".syngt",
            PortSyng.build_from_fasta([fa]), JaxSyng.build_from_fasta([fa]))


def _cli(main, argv, capsys, **kw):
    capsys.readouterr()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue(), capsys.readouterr().err


def _both(argv, capsys, out_flag=None, tmp=None):
    """Both CLIs on `argv`: (status, stdout, stderr, output bytes) each;
    with `out_flag`, each side writes its own -O file (or bundle directory,
    every file in name order) under `tmp`."""
    res = []
    for side, main, kw in (("ref", jax_cli.main, {}),
                           ("port", torch_cli.main, {"device": "cpu"})):
        extra = []
        if out_flag:
            path = os.path.join(tmp, f"{side}_{out_flag}")
            extra = ["-O", path]
        rc, out, err = _cli(main, argv + extra, capsys, **kw)
        data = None
        if out_flag and os.path.isdir(path):
            data = {n: open(os.path.join(path, n), "rb").read()
                    for n in sorted(os.listdir(path))}
        elif out_flag and os.path.exists(path):
            data = open(path, "rb").read()
        if out_flag:
            err = err.replace(path, "<out>")
        res.append((rc, out, err, data))
    return res


def _chains(chains):
    return [dataclasses.asdict(c) for c in chains]


def _rows(rows):
    return [(r.q_id, r.q_first, r.q_last, r.cigar, r.t_id, r.t_first,
             r.t_last) for r in rows]


# ---- the syng-map and proj cases of tests/test_map_genotype.py -----------


@pytest.mark.parametrize("engine", ["host", "device"])
def test_cli_syng_map_gaf(panel, tmp_path, capsys, engine):
    """map -o gaf on a syng index: syng-gaf-walk rows (main.rs:516)."""
    tmp, fa, seq_data, fastq, syngt, _, _ = panel
    rng = random.Random(5)
    reads_fa = tmp_path / "long.fa"
    with open(reads_fa, "w") as fh:
        for i in range(20):
            s = rng.randint(0, len(seq_data["ref"]) - 800)
            fh.write(f">lr{i}\n{seq_data['ref'][s:s+800]}\n")
    ref, got = _both(["map", "-a", syngt, "-q", str(reads_fa), "-o", "gaf",
                      "--compute-engine", engine], capsys, "gaf",
                     str(tmp_path))
    assert got == ref and got[0] == 0
    rows = [l.split("\t") for l in got[3].decode().splitlines()]
    assert len(rows) >= 15
    for f in rows:
        assert f[4] == "+"
        assert f[5][0] in "><"
        assert int(f[1]) == 800
        assert 0 <= int(f[2]) < int(f[3]) <= 800
        tags = {t.split(":")[0]: t for t in f[12:]}
        assert "an" in tags and "sk" in tags and "qp" in tags
        n_nodes = f[5].count(">") + f[5].count("<")
        assert int(tags["an"].split(":")[2]) == n_nodes
        qp = [int(x) for x in tags["qp"].split(",")[1:]]
        assert len(qp) == n_nodes
        assert qp == sorted(qp)
    # Without -O the rows go to standard output, and --min-anchors filters.
    ref, got = _both(["map", "-a", syngt, "-q", fastq, "-o", "gaf",
                      "--min-anchors", "2"], capsys)
    assert got == ref and got[1].count("\n") > 100


@pytest.mark.parametrize("extra", [
    ["--min-anchors", "3"], ["--max-hits", "1"], ["--chain-budget", "500"],
], ids=["min_anchors", "max_hits", "chain_budget"])
def test_cli_syng_map_paf(panel, tmp_path, capsys, extra):
    """map -o paf on a syng index: chained anchor projections."""
    tmp, fa, seq_data, fastq, syngt, _, _ = panel
    rng = random.Random(6)
    s = rng.randint(0, len(seq_data["ref"]) - 2000)
    reads_fa = tmp_path / "frag.fa"
    rc_frag = reverse_complement(seq_data["s2"][1000:3000].encode()).decode()
    reads_fa.write_text(f">frag\n{seq_data['ref'][s:s+2000]}\n"
                        f">rcfrag\n{rc_frag}\n")
    ref, got = _both(["map", "-a", syngt, "-q", str(reads_fa), "-o", "paf"]
                     + extra, capsys, "paf", str(tmp_path))
    assert got == ref and got[0] == 0
    rows = [l.split("\t") for l in got[3].decode().splitlines()]
    assert rows
    top = rows[0]
    assert top[0] == "frag" and top[5] == "ref"
    t0, t1 = int(top[7]), int(top[8])
    assert abs(t0 - s) < 200 and abs(t1 - (s + 2000)) < 200
    assert top[4] == "+"
    for f in rows:
        assert int(f[2]) < int(f[3]) and int(f[7]) < int(f[8])
        assert any(t.startswith("an:i:") for t in f[12:])
    if extra[0] == "--max-hits":
        assert [f[0] for f in rows].count("frag") == 1


def test_map_rc_read_projects_reverse(panel):
    """An RC fragment maps to ref with '-' strand via chained anchors."""
    tmp, fa, seq_data, fastq, syngt, port_idx, jax_idx = panel
    frag = reverse_complement(seq_data["ref"][3000:5000].encode())
    rows = port_map.map_read(port_idx, "rcread", frag, min_anchors=3)
    assert rows == jax_map.map_read(jax_idx, "rcread", frag, min_anchors=3)
    top = rows[0].split("\t")
    assert top[5] == "ref" and top[4] == "-"
    assert abs(int(top[7]) - 3000) < 200 and abs(int(top[8]) - 5000) < 200


@pytest.mark.parametrize("engine", ["host", "device"])
def test_proj_bundle_carries_gaf(panel, tmp_path, capsys, engine):
    """map -o proj: the bundle's pack, GAF and manifest are impg_tpu's (the
    pack through K-G's twin on the device engine)."""
    import json

    tmp, fa, seq_data, fastq, syngt, _, _ = panel
    ref, got = _both(["map", "-a", syngt, "-q", fastq, "-o", "proj",
                      "--compute-engine", engine], capsys, "proj",
                     str(tmp_path))
    assert got == ref and got[0] == 0
    files = got[3]
    assert sorted(files) == ["manifest.json", "sample.gaf", "sample.packt"]
    manifest = json.loads(files["manifest.json"])
    assert manifest["read_space"] == "syng-gaf-walk"
    assert manifest["files"]["gaf"] == "sample.gaf"
    gaf_lines = files["sample.gaf"].decode().splitlines()
    assert len(gaf_lines) == manifest["n_gaf_records"] > 0


def test_matched_syncmers_and_rows_equal_jax(panel):
    """matched_query_syncmers (both orientations), gaf_row and map_read on
    reads of every haplotype, forward and reverse complemented, some
    shorter than a syncmer."""
    tmp, fa, seq_data, fastq, syngt, port_idx, jax_idx = panel
    rng = np.random.default_rng(3)
    assert np.array_equal(port_map.index_universe(port_idx),
                          jax_map.index_universe(jax_idx))
    n_rows = 0
    for name, seq in seq_data.items():
        for length in (40, 150, 700):
            s = int(rng.integers(0, len(seq) - length))
            read = seq[s:s + length].encode()
            for r in (read, reverse_complement(read)):
                got = port_map.matched_query_syncmers(port_idx, r)
                ref = jax_map.matched_query_syncmers(jax_idx, r)
                for a, b in zip(got[:3], ref[:3]):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
                assert got[3] == ref[3]
                assert port_map.gaf_row(name, len(r), port_idx.syncmer_len,
                                        got[0], got[2]) == \
                    jax_map.gaf_row(name, len(r), jax_idx.syncmer_len,
                                    ref[0], ref[2])
                rows = port_map.map_read(port_idx, name, r)
                assert rows == jax_map.map_read(jax_idx, name, r)
                n_rows += len(rows)
    assert n_rows > 10


# ---- the cases of tests/test_syng_transitive.py without refinement -------


def test_chain_region_finds_homologs(trans_panel):
    tmp, fa, seq_data, syngt, port_idx, jax_idx = trans_panel
    chains = port_tr.chain_region(port_idx, "ref", 2_000, 10_000)
    assert _chains(chains) == _chains(
        jax_tr.chain_region(jax_idx, "ref", 2_000, 10_000))
    assert chains
    genomes = {c.genome for c in chains}
    assert genomes & {"s0", "s1", "s2"}, genomes
    for c in chains:
        assert c.n_anchors >= 3
        assert 0 <= c.t_start < c.t_end
        assert c.q_start < c.q_end
        assert c.q_start >= 1_000 and c.q_end <= 11_000
        assert c.strand in "+-"
    best = max(chains, key=lambda c: c.t_end - c.t_start)
    assert best.t_end - best.t_start > 4_000
    for kw in (dict(scaffold_gap=300, min_anchors=1, extend_budget=0),
               dict(drop_top_fraction=0.2, max_occurrences=2)):
        assert _chains(port_tr.chain_region(port_idx, "s1", 0, 15_000,
                                            **kw)) == \
            _chains(jax_tr.chain_region(jax_idx, "s1", 0, 15_000, **kw))


def test_chain_region_reverse_strand(trans_panel, tmp_path):
    tmp, fa, seq_data, syngt, _, _ = trans_panel
    rc = reverse_complement(seq_data["ref"].encode()).decode()
    fa2 = str(tmp_path / "rc.fa")
    datagen.write_fasta(fa2, {"fwd": seq_data["ref"], "rev": rc})
    got = port_tr.chain_region(PortSyng.build_from_fasta([fa2]), "fwd",
                               1_000, 6_000)
    assert _chains(got) == _chains(jax_tr.chain_region(
        JaxSyng.build_from_fasta([fa2]), "fwd", 1_000, 6_000))
    chains = [c for c in got if c.genome == "rev"]
    assert chains
    assert all(c.strand == "-" for c in chains)
    L = len(seq_data["ref"])
    best = max(chains, key=lambda c: c.n_anchors)
    assert abs((L - best.t_end) - best.q_start) < 1_200
    assert abs((L - best.t_start) - best.q_end) < 1_200


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3])
def test_query_transitive_walk(trans_panel, max_depth):
    tmp, fa, seq_data, syngt, port_idx, jax_idx = trans_panel
    rows = port_tr.query_transitive(port_idx, "ref", 2_000, 10_000,
                                    max_depth=max_depth)
    assert _rows(rows) == _rows(jax_tr.query_transitive(
        jax_idx, "ref", 2_000, 10_000, max_depth=max_depth))
    assert rows[0].q_id == rows[0].t_id == port_idx.seq_index.get_id("ref")
    hit_names = {port_idx.seq_index.get_name(r.q_id) for r in rows[1:]}
    assert hit_names & {"s0", "s1", "s2"}
    kw = dict(min_transitive_len=3000, min_distance_between_ranges=500)
    assert _rows(port_tr.query_transitive(port_idx, "s2", 0, 15_000,
                                          max_depth=max_depth, **kw)) == \
        _rows(jax_tr.query_transitive(jax_idx, "s2", 0, 15_000,
                                      max_depth=max_depth, **kw))
    with pytest.raises(KeyError):
        port_tr.query_transitive(port_idx, "nope", 0, 10)
    # With sequences the chain ends refine, as in impg_tpu.
    from impg_tpu.io.fasta import UnifiedSequenceIndex as JaxSeqs
    from impg_tpu_torch.io.fasta import UnifiedSequenceIndex as PortSeqs

    assert _rows(port_tr.query_transitive(
        port_idx, "ref", 2_000, 10_000, max_depth=max_depth,
        seq_idx=PortSeqs.from_files([fa]))) == \
        _rows(jax_tr.query_transitive(
            jax_idx, "ref", 2_000, 10_000, max_depth=max_depth,
            seq_idx=JaxSeqs.from_files([fa])))


@pytest.mark.parametrize("fmt", ["bed", "bedpe"])
@pytest.mark.parametrize("walk", ["raw", "x", "x_m1", "bed_file"])
def test_cli_syng_query(trans_panel, tmp_path, capsys, fmt, walk):
    """query -a X.syngt -o bed|bedpe, raw and -x: impg_tpu.cli's bytes."""
    tmp, fa, seq_data, syngt, _, _ = trans_panel
    argv = ["query", "-a", syngt, "-d", "100", "-o", fmt]
    if walk == "bed_file":
        bed = tmp_path / "t.bed"
        bed.write_text("ref\t2000\t10000\tlocus\ns1\t0\t5000\n")
        argv += ["-b", str(bed), "-x", "--consider-strandness"]
    else:
        argv += ["-r", "ref:2000-10000"]
        argv += {"raw": [], "x": ["-x"], "x_m1": ["-x", "-m", "1",
                                                  "--no-merge"]}[walk]
    ref, got = _both(argv, capsys, fmt, str(tmp_path))
    assert got == ref and got[0] == 0
    lines = [l for l in got[3].decode().splitlines() if l]
    assert lines
    names = {l.split("\t")[0] for l in lines} | \
        {l.split("\t")[3] for l in lines if fmt == "bedpe"}
    assert names & {"s0", "s1", "s2"}, names
    if fmt == "bed":
        assert "ref" in names


def test_cli_syng_query_errors_equal_jax(trans_panel, capsys):
    """A format impg_tpu's syng queries do not support, and a sequence not
    in the index, give impg_tpu.cli's status and message."""
    tmp, fa, seq_data, syngt, _, _ = trans_panel
    for argv in (["query", "-a", syngt, "-r", "ref:0-100", "-d", "10",
                  "-o", "paf"],
                 ["query", "-a", syngt, "-r", "nope:0-100", "-d", "10"],
                 ["query", "-a", syngt, "-r", "ref:0-100"]):
        ref, got = _both(argv, capsys)
        assert got == ref and got[0] in (1, 2), argv


def test_sweep_chaining_reports_duplicated_copies(tmp_path):
    rng = random.Random(91)
    core = "".join(rng.choice("ACGT") for _ in range(2500))
    b = (
        "".join(rng.choice("ACGT") for _ in range(1000))
        + core
        + "".join(rng.choice("ACGT") for _ in range(2000))
        + core
        + "".join(rng.choice("ACGT") for _ in range(1000))
    )
    a = "".join(rng.choice("ACGT") for _ in range(600)) + core + "".join(
        rng.choice("ACGT") for _ in range(600)
    )
    fa = str(tmp_path / "dup.fa")
    datagen.write_fasta(fa, {"A": a, "B": b})
    chains = port_tr.chain_region(PortSyng.build_from_fasta([fa]), "A", 600,
                                  600 + len(core))
    assert _chains(chains) == _chains(jax_tr.chain_region(
        JaxSyng.build_from_fasta([fa]), "A", 600, 600 + len(core)))
    b_chains = [c for c in chains if c.genome == "B"]
    assert len(b_chains) >= 2, b_chains
    starts = sorted(c.t_start for c in b_chains)
    assert abs(starts[0] - 1000) < 1200
    assert abs(starts[-1] - 5500) < 1200


@pytest.mark.parametrize("argv", [
    ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-x",
     "--sequence-files", "missing.fa"],
    ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10",
     "--sequence-list", "missing.txt"],
    ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-o", "gfa"],
    ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-o",
     "gfa:sort"],
    ["query", "-a", "missing.syngt", "-r", "x:0-10", "-d", "10", "-o",
     "gbwt"],
    ["index", "-a", "missing.syngt"],
    ["stats", "-a", "missing.syngt"],
    ["query", "-a", "missing.syngt,other.paf", "-r", "x:0-10", "-d", "10"],
], ids=["sequence_files", "sequence_list", "gfa", "gfa_pipeline", "gbwt",
        "index", "stats", "two_inputs"])
def test_cli_syngt_unported_exit_2(argv, capsys):
    """These were refused until the port took them: sequence files
    (chain-end refinement), `-o gfa`, `gfa:` pipelines and `-o gbwt` of a
    `.syngt` query, `.syngt` inputs of index and stats, and a `.syngt`
    beside a PAF.  On the same missing inputs (the index does not exist)
    each now gives impg_tpu.cli's status and message."""
    ref, got = _both(argv, capsys)
    assert got == ref and got[0] in (1, 2)
    assert "not yet ported" not in got[2]
