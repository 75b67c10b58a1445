"""The port's POA and region outputs against impg_tpu's, on the CPU.

graph/poa.py's `poa_align` (MSA, node bases, edges, edge weights, paths;
with and without the exact duplicate fan-out of IMPG_POA_DEDUP),
`poa_to_gfa`; graph/region.py's GFA, MAF and aligned FASTA; graph/vcf.py's
`gfa_to_vcf`; graph/lace.py's `lace_gfas`; commands/similarity.py's rows,
distance matrix, MDS and sign polarisation; and the port's CLI `query -o
gfa|maf|fasta-aln|vcf` and `similarity` byte for byte against impg_tpu.cli
on the port's host, native and device (the kernels' plain twins) engines.
The port's POA is its own build of the same C++ source (io/native.py);
impg_tpu's runs from the tests' private build (tests/torch_reference_
native.py).  Exact throughout: bytes and arrays."""

import io
import random

import numpy as np
import pytest

import impg_tpu.cli as jax_cli
import impg_tpu_torch.cli as torch_cli
from impg_tpu.commands import similarity as jax_sim
from impg_tpu.graph import lace as jax_lace
from impg_tpu.graph import poa as jax_poa
from impg_tpu.graph import region as jax_region
from impg_tpu.graph import vcf as jax_vcf
from impg_tpu.index import impg_index as jax_index
from impg_tpu.io import fasta as jax_fasta
from impg_tpu.query import engine as jax_engine
from impg_tpu_torch.commands import similarity as port_sim
from impg_tpu_torch.graph import lace as port_lace
from impg_tpu_torch.graph import poa as port_poa
from impg_tpu_torch.graph import region as port_region
from impg_tpu_torch.graph import vcf as port_vcf
from impg_tpu_torch.index import impg_index as port_index
from impg_tpu_torch.io import fasta as port_fasta
from impg_tpu_torch.query import engine as port_engine
from tests import datagen
from tests.torch_reference_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

BASES = "ACGT"


def _variants(rng, n_seqs, length, n_dups):
    """`n_seqs` mutants of one random sequence (SNPs and short indels),
    then `n_dups` exact copies of earlier ones, shuffled in."""
    root = [rng.choice(BASES) for _ in range(length)]
    out = []
    for _ in range(n_seqs):
        s = list(root)
        for _ in range(rng.randrange(1, 8)):
            p = rng.randrange(len(s))
            r = rng.random()
            if r < 0.6:
                s[p] = rng.choice(BASES)
            elif r < 0.8:
                del s[p:p + rng.randrange(1, 4)]
            else:
                s[p:p] = [rng.choice(BASES) for _ in range(rng.randrange(1, 4))]
        out.append("".join(s).encode())
    for _ in range(n_dups):
        out.insert(rng.randrange(len(out) + 1), rng.choice(out))
    return out


def _poa_fields(r):
    return (r.msa, r.node_bases, r.edges.tolist(), r.edge_weights.tolist(),
            [p.tolist() for p in r.paths])


@pytest.mark.parametrize("dedup", ["1", "0"])
@pytest.mark.parametrize("seed,n,length,dups,scoring", [
    (1, 6, 120, 3, (1, 4, 6, 2, 26, 1)),
    (2, 12, 300, 5, (1, 4, 6, 2, 26, 1)),
    (3, 4, 80, 0, (2, 3, 5, 1, 12, 1)),
    (4, 1, 50, 0, (1, 4, 6, 2, 26, 1)),
    (5, 9, 200, 8, (1, 2, 4, 2, 0, 0)),
])
def test_poa_align_equals_jax(monkeypatch, dedup, seed, n, length, dups,
                              scoring):
    monkeypatch.setenv("IMPG_POA_DEDUP", dedup)
    seqs = _variants(random.Random(seed), n, length, dups)
    got = port_poa.poa_align(seqs, scoring)
    ref = jax_poa.poa_align(seqs, scoring)
    assert _poa_fields(got) == _poa_fields(ref)
    assert [row.replace("-", "").encode() for row in got.msa] == seqs
    names = [f"s{i}:0-{len(s)}" for i, s in enumerate(seqs)]
    assert port_poa.poa_to_gfa(got, names) == jax_poa.poa_to_gfa(ref, names)


def test_poa_dedup_fan_out_is_exact(monkeypatch):
    """The fan-out of duplicates gives the MSA, nodes, edges and paths of
    the run without it (only the edge weights reflect the deduped run)."""
    seqs = _variants(random.Random(9), 8, 150, 6)
    monkeypatch.setenv("IMPG_POA_DEDUP", "1")
    fan = port_poa.poa_align(seqs)
    monkeypatch.setenv("IMPG_POA_DEDUP", "0")
    raw = port_poa.poa_align(seqs)
    assert fan.msa == raw.msa and fan.node_bases == raw.node_bases
    assert fan.edges.tolist() == raw.edges.tolist()
    assert [p.tolist() for p in fan.paths] == [p.tolist() for p in raw.paths]


def test_poa_without_native_library_raises(monkeypatch):
    from impg_tpu_torch.io import native

    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native POA library unavailable"):
        port_poa.poa_align([b"ACGT", b"ACGA"])


# ---- region outputs, VCF, lace, similarity over one pangenome -------------


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A chain pangenome (both strands) with its sequences: each package's
    index, sequence index and walks of a few windows of ref."""
    text, _, _, seq_data = datagen.mutate_chain_paf(
        random.Random(31), n_seqs=5, seq_len=3000, return_sequences=True)
    tmp = tmp_path_factory.mktemp("poachain")
    sides = {}
    windows = [(200, 900), (850, 1700), (1650, 2400), (2350, 2990)]
    for side, idx_mod, fa_mod, eng in (
            ("jax", jax_index, jax_fasta, jax_engine),
            ("port", port_index, port_fasta, port_engine)):
        d = tmp / side
        d.mkdir()
        (d / "chain.paf").write_text(text)
        datagen.write_fasta(str(d / "chain.fa"), seq_data)
        index = idx_mod.ImpgIndex.from_paf_files([str(d / "chain.paf")])
        seq_idx = fa_mod.UnifiedSequenceIndex.from_files([str(d / "chain.fa")])
        rid = index.seq_index.get_id("ref")
        walks = eng.query_transitive_bfs_many(
            index, [(rid, s, e) for s, e in windows], max_depth=3)
        sides[side] = (index, seq_idx, walks)
    return sides


@pytest.mark.parametrize("w", range(4))
@pytest.mark.parametrize("gen", ["generate_gfa", "generate_maf",
                                 "generate_fasta_aln"])
def test_region_outputs_equal_jax(chain, gen, w):
    texts = []
    for side, mod in (("jax", jax_region), ("port", port_region)):
        index, seq_idx, walks = chain[side]
        texts.append(getattr(mod, gen)(index, list(walks[w]), seq_idx))
    assert texts[0] == texts[1]
    assert len(texts[0].splitlines()) > 5


def test_flip_reverse_paths_equal_jax(chain):
    """A reverse-strand row's path is reversed with flipped orientations."""
    index, seq_idx, walks = chain["port"]
    rows = [r for w in walks for r in w]
    assert any(r.q_first > r.q_last for r in rows)
    got = port_region.generate_gfa(index, rows[:6], seq_idx)
    j_index, j_seq, j_walks = chain["jax"]
    j_rows = [r for w in j_walks for r in w]
    assert got == jax_region.generate_gfa(j_index, j_rows[:6], j_seq)
    meta = [m for _, m in port_sim.prepare_sequences(index, rows[:6],
                                                     seq_idx)]
    assert any(m.strand == "-" for m in meta)


@pytest.mark.parametrize("reference", [None, "s1", "s2:", "missing"])
def test_gfa_to_vcf_equals_jax(chain, reference):
    index, seq_idx, walks = chain["port"]
    gfa = port_region.generate_gfa(index, list(walks[1]), seq_idx)
    if reference == "s2:":
        reference = next(ln.split("\t")[1] for ln in gfa.splitlines()
                         if ln.startswith("P\ts2:"))
    if reference == "missing":
        with pytest.raises(ValueError) as e_got:
            port_vcf.gfa_to_vcf(gfa, reference)
        with pytest.raises(ValueError) as e_ref:
            jax_vcf.gfa_to_vcf(gfa, reference)
        assert str(e_got.value) == str(e_ref.value)
        return
    got = port_vcf.gfa_to_vcf(gfa, reference)
    assert got == jax_vcf.gfa_to_vcf(gfa, reference)
    assert sum(not ln.startswith("#") for ln in got.splitlines()) > 0
    assert port_vcf.gfa_to_vcf("H\tVN:Z:1.0\n") == jax_vcf.gfa_to_vcf(
        "H\tVN:Z:1.0\n")


@pytest.mark.parametrize("fill_gaps", [False, True])
def test_lace_gfas_equals_jax(chain, fill_gaps):
    """The windows' graphs overlap (their ranges do) and leave gaps between
    some paths' ranges: laced with and without gap filling from the
    sequences."""
    texts = []
    for side, lace in (("jax", jax_lace), ("port", port_lace)):
        index, seq_idx, walks = chain[side]
        mod = jax_region if side == "jax" else port_region
        gfas = [mod.generate_gfa(index, list(w), seq_idx) for w in walks]
        texts.append(lace.lace_gfas(gfas, fill_gaps=fill_gaps,
                                    sequence_index=seq_idx))
    assert texts[0] == texts[1]
    assert texts[0].count("\nP\t") >= 3
    with pytest.raises(ValueError) as e_got:
        port_lace.lace_gfas(["H\tVN:Z:1.0\nP\tx:0-4\t9+\t*\n"])
    with pytest.raises(ValueError) as e_ref:
        jax_lace.lace_gfas(["H\tVN:Z:1.0\nP\tx:0-4\t9+\t*\n"])
    assert str(e_got.value) == str(e_ref.value)


@pytest.mark.parametrize("distances,all_pairs,delim", [
    (False, False, None), (True, False, None), (False, True, None),
    (False, False, ":"), (True, True, "s"),
])
def test_similarity_rows_equal_jax(chain, distances, all_pairs, delim):
    outs = []
    for side, sim in (("jax", jax_sim), ("port", port_sim)):
        index, seq_idx, walks = chain[side]
        text, sims = sim.compute_similarities_for_region(
            index, list(walks[2]), seq_idx, sim.poa_mod.DEFAULT_SCORING,
            distances, all_pairs, delim, 1, "ref:1650-2400")
        dm, labels = sim.build_distance_matrix(sims, "cosine")
        coords, vals = sim.mds_fit_transform(dm, 3)
        outs.append((text, [(a, b, vars(m)) for a, b, m in sims],
                     dm.tolist(), labels, coords.tolist(), vals.tolist()))
    assert outs[0] == outs[1]
    assert outs[0][0].count("\n") >= 3
    for v in (0.0, 1.0, 0.123456789, 1 / 3, 2e-9):
        assert port_sim.format_value(v) == jax_sim.format_value(v)


def _pca_windows(sim, seed):
    rng = np.random.default_rng(seed)
    labels = [f"h{i}" for i in range(5)]
    return [sim.PcaResult(region=f"r:{i}", labels=labels[:4 + (i % 2)],
                          coords=rng.normal(size=(4 + (i % 2), 2)))
            for i in range(7)]


@pytest.mark.parametrize("how", ["adaptive", "guides", "missing_guide"])
def test_pca_polarisation_equals_jax(how):
    res = []
    for sim in (jax_sim, port_sim):
        wins = _pca_windows(sim, 3)
        try:
            if how == "adaptive":
                sim.polarize_adaptive(wins, 3)
            elif how == "guides":
                sim.polarize_with_guides(wins, ["h4", "h1"])
            else:
                sim.polarize_with_guides(wins, ["nobody"])
        except ValueError as e:
            res.append(str(e))
            continue
        res.append([w.coords.tolist() for w in wins])
    assert res[0] == res[1]


# ---- the CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    text, _, _, seq_data = datagen.mutate_chain_paf(
        random.Random(44), n_seqs=5, seq_len=2500, return_sequences=True)
    tmp = tmp_path_factory.mktemp("poacli")
    out = {}
    for side in ("jax", "port"):
        d = tmp / side
        d.mkdir()
        (d / "chain.paf").write_text(text)
        datagen.write_fasta(str(d / "chain.fa"), seq_data)
        (d / "windows.bed").write_text(
            "ref\t100\t800\tw0\nref\t700\t1500\tw1\ns1\t400\t1200\tw2\n")
        out[side] = str(d)
    return out


def _run(main, d, argv, capsys, **kw):
    argv = [a.format(d=d) for a in argv]
    capsys.readouterr()
    try:
        rc = main(argv, **kw)
    except SystemExit as e:
        rc = ("exit", e.code)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err.replace(d, "<d>")


REGION_CASES = {
    "windows": ["-b", "{d}/windows.bed", "-x"],
    "one_range": ["-r", "ref:300-1400", "-x", "-m", "3"],
    "strands_kept": ["-b", "{d}/windows.bed", "-x", "--consider-strandness"],
    "scoring": ["-r", "ref:300-1400", "-x", "--poa-scoring", "2,3,5,1,12,1"],
    "not_transitive": ["-r", "s2:100-1000"],
}


@pytest.mark.parametrize("engine", ["host", "native", "device"])
@pytest.mark.parametrize("fmt", ["gfa", "maf", "fasta-aln", "vcf"])
@pytest.mark.parametrize("case", list(REGION_CASES))
def test_query_region_cli_matches_jax(cli_dirs, capsys, case, fmt, engine):
    argv = ["query", "-a", "{d}/chain.paf", "-d", "50", "-o", fmt,
            "--sequence-files", "{d}/chain.fa", *REGION_CASES[case],
            "--compute-engine"]
    got = _run(torch_cli.main, cli_dirs["port"], argv + [engine], capsys,
               device="cpu")
    ref = _run(jax_cli.main, cli_dirs["jax"],
               argv + ["native" if engine == "native" else "host"], capsys)
    if ref[0] == ("exit", 2):
        # Walks that are not transitive: the native engine refuses them.
        assert engine == "native" and got[0] == ref[0]
        return
    assert got == ref
    assert ref[0] == 0 and len(ref[1].splitlines()) > 4


SIM_CASES = {
    "pca": ["--pca"],
    "distances_all": ["--distances", "--all", "--pca", "--pca-similarity",
                      "cosine"],
    "delim": ["--delim", ":", "--pca", "--pca-components", "3"],
    "polarize_adaptive": ["--pca", "--polarize-n-prev", "2"],
    "polarize_guides": ["--pca", "--polarize-guide-samples",
                        "ref:100-800"],
    "missing_guide": ["--pca", "--polarize-guide-samples", "nobody"],
    "dfs": ["--transitive-dfs", "--pca"],
    "sequence_list": ["--sequence-list", "{d}/seqs.txt", "--pca"],
}


@pytest.mark.parametrize("engine", ["host", "native", "device"])
@pytest.mark.parametrize("case", list(SIM_CASES))
def test_similarity_cli_matches_jax(cli_dirs, capsys, case, engine):
    """One walk a target, as impg_tpu.cli runs them: rows, `#PCA` lines and
    exit statuses the same bytes."""
    for side in ("jax", "port"):
        with open(f"{cli_dirs[side]}/seqs.txt", "w") as fh:
            fh.write(f"{cli_dirs[side]}/chain.fa\n")
    files = ([] if "--sequence-list" in SIM_CASES[case]
             else ["--sequence-files", "{d}/chain.fa"])
    argv = ["similarity", "-a", "{d}/chain.paf", "-b", "{d}/windows.bed",
            "-d", "50", "-x", *files, *SIM_CASES[case], "--compute-engine"]
    got = _run(torch_cli.main, cli_dirs["port"], argv + [engine], capsys,
               device="cpu")
    ref = _run(jax_cli.main, cli_dirs["jax"],
               argv + ["native" if engine == "native" else "host"], capsys)
    assert got == ref
    if case == "missing_guide":
        assert ref[0] == 1 and "not found in any window" in ref[2]
    else:
        assert ref[0] == 0 and ref[1].count("#PCA\t") >= 6


def test_similarity_needs_sequences(cli_dirs, capsys):
    argv = ["similarity", "-a", "{d}/chain.paf", "-r", "ref:100-800", "-d",
            "50"]
    got = _run(torch_cli.main, cli_dirs["port"], argv, capsys, device="cpu")
    ref = _run(jax_cli.main, cli_dirs["jax"], argv, capsys)
    assert got == ref and ref[0] == 2


@pytest.mark.parametrize("argv", [
    ["query", "-o", "gfa", "--gfa-engine", "seqwish"],
    ["query", "-o", "vcf", "--gfa-engine", "pggb"],
    ["query", "-o", "gfa", "--gfa-engine", "syng-native"],
    ["query", "-o", "gfa:sort"],
    ["query", "-o", "gfa:cut-n=10"],
    ["query", "-o", "gbwt", "-O", "x"],
    ["similarity", "-a", "x.syngt", "--sequence-files", "x.fa"],
    ["similarity", "-a", "x.1aln", "--sequence-files", "x.fa"],
], ids=["seqwish", "pggb", "syng_native", "gfa_pipeline", "cut_n", "gbwt",
        "similarity_syngt", "similarity_1aln"])
def test_unported_region_paths_exit_2(capsys, argv):
    """These were refused until the port took them: the seqwish, pggb and
    syng-native engines, the `gfa:` pipelines, `-o gbwt` and `.syngt`/
    `.1aln` inputs of `similarity`.  On the same missing input (the inputs
    do not exist) each now gives impg_tpu.cli's status and message."""
    full = argv[:1] + (["-a", "missing.paf"] if "-a" not in argv else []) + \
        argv[1:] + ["-r", "x:0-10", "-d", "10"]
    got = _run(torch_cli.main, "<no dir>", full, capsys, device="cpu")
    assert got == _run(jax_cli.main, "<no dir>", full, capsys)
    assert got[0] == 1 and "No such file" in got[2]
    assert "not yet ported" not in got[2]


def test_maf_with_gfa_engine_ignores_it(cli_dirs, capsys):
    """--gfa-engine only chooses the graph of -o gfa|vcf: -o maf runs POA
    under any engine name, as in impg_tpu."""
    argv = ["query", "-a", "{d}/chain.paf", "-r", "ref:300-1400", "-d", "50",
            "-x", "-o", "maf", "--sequence-files", "{d}/chain.fa",
            "--gfa-engine", "seqwish", "--compute-engine", "host"]
    got = _run(torch_cli.main, cli_dirs["port"], argv, capsys, device="cpu")
    ref = _run(jax_cli.main, cli_dirs["jax"], argv, capsys)
    assert got == ref and ref[0] == 0


def test_region_gfa_spells_sequences(cli_dirs, capsys):
    """The port's -o gfa paths spell their region sequences (reverse
    paths spell the reverse complement)."""
    d = cli_dirs["port"]
    rc, out, _ = _run(torch_cli.main, d, [
        "query", "-a", "{d}/chain.paf", "-r", "ref:300-1400", "-d", "50",
        "-x", "-o", "gfa", "--sequence-files", "{d}/chain.fa",
        "--compute-engine", "device"], capsys, device="cpu")
    assert rc == 0
    seq_idx = port_fasta.UnifiedSequenceIndex.from_files([f"{d}/chain.fa"])
    segs = {}
    n_paths = 0
    for line in io.StringIO(out):
        f = line.rstrip("\n").split("\t")
        if f[0] == "S":
            segs[f[1]] = f[2].encode()
        elif f[0] == "P":
            name, rng = f[1].rsplit(":", 1)
            s, e = map(int, rng.split("-"))
            want = seq_idx.fetch_sequence(name, s, e)
            got = b"".join(
                port_fasta.reverse_complement(segs[st[:-1]])
                if st.endswith("-") else segs[st[:-1]]
                for st in f[2].split(","))
            assert got in (want, port_fasta.reverse_complement(want)), name
            n_paths += 1
    assert n_paths >= 3
