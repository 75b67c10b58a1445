"""The port must run where neither JAX nor impg_tpu is installed, and must not
load either where they are: a fresh interpreter with `import jax` and `import
impg_tpu` blocked (names matched exactly, so impg_tpu_torch passes), and every
attempt recorded, imports the port and runs one small CPU query through the
engines (exact, approximate, paged) and through the CLI (`index`, `query -x`
bed/bedpe/paf, `--approximate`, paged, `stats -r/-b`, `partition -o bed|paf`
resident and paged, `refine -x`), then the syng path
`syng` -> `map` -> `genotype cos` on the device (CPU twins) and host
engines, `map -a -o proj|gaf|paf` and `.syngt` queries (bed, bedpe, raw
and -x), `sort` of a variation graph with the numpy and device (K-I's
twin) path-SGD backends, `map --graph -o graph-pack-tsv|gaf|paf` and
`genotype --graph` on the device (the products' and K-H's twins) and host
engines, `query -o fasta|gfa|vcf` and `similarity --pca` (the sequence
layer and the POA) on the device and native engines, `query -o gfa
--gfa-engine pggb` (alignment, seqwish and the pggb chain) and a `-o gfa:`
pipeline, `.syngt` queries with sequence files (chain-end refinement, a
region graph); the tracepoint files (`export-1aln --binary` and
`export-tpa`, then `query -x` on each, approximate and with sequences, on
the device engine); `-o gbwt` of a PAF and of a `.syngt` query; and the
syng tools (`read-index`, `infer` with `--gaf`, `--read-index` and
`--write-haplotypes`, `syng2gfa`, `syng-repair`); and the GFA toolbox
(`align` and its job list, `graph` on the poa and pggb engines, with a
given PAF and partitioned, `normalize`, `normalize-self-loops`, `smooth`,
`crush`, `render-graph`, `lace`, `agz create|list`, a `render` bundle over
the archive, `project`, `gfa2vcf` and `graph-report`)."""

import os
import random
import subprocess
import sys

from impg_tpu_torch import synth
from impg_tpu_torch.graph.gfa import Gfa
from tests import datagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
tried = []


BLOCKED = ("jax", "impg_tpu")


def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


class NoJax:
    # Any `import jax` or `import impg_tpu` raises ImportError and is
    # recorded: code that catches the error (a fallback for hosts without
    # them) still counts.
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            tried.append(name)
            raise ImportError(f"blocked: {name}")


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, sys.argv[1])
import impg_tpu_torch
import impg_tpu_torch.cli
import impg_tpu_torch.commands.partition
import impg_tpu_torch.commands.refine
import impg_tpu_torch.io.native
import impg_tpu_torch.ops.approx
import impg_tpu_torch.query.device
import impg_tpu_torch.query.paged
import impg_tpu_torch.synth
from impg_tpu_torch.host import load_or_build
from impg_tpu_torch import host as engine
from impg_tpu_torch.query.device import TorchDeviceEngine
from impg_tpu_torch.query.paged import TorchPagedEngine

index = load_or_build([sys.argv[2]])
rid = index.seq_index.get_id("ref")
engines = (
    (TorchDeviceEngine(index, device="cpu"), False),
    (TorchDeviceEngine(index, device="cpu", with_tracepoints=True), True),
    (TorchPagedEngine(index, "cpu", hbm_budget_bytes=1 << 16), False),
)
for eng, approximate in engines:
    blocks = engine.query_transitive_bfs_many(
        index, [(rid, 500, 2500)], max_depth=2, device_engine=eng,
        columnar=True, approximate=approximate,
    )
    assert len(blocks[0]) > 1, len(blocks[0])
import os
assert impg_tpu_torch.io.native.load() is not None
assert impg_tpu_torch.cli.main(["index", "-a", sys.argv[2]]) == 0
query = ["query", "-a", sys.argv[2], "-r", "ref:500-2500", "-d", "100", "-x"]
stats = ["stats", "-a", sys.argv[2], "-r", "ref:500-2500"]
bed = sys.argv[2] + ".bed"
with open(bed, "w") as fh:
    fh.write("ref\t500\t2500\ts1\t0\t3000\n")
runs = [(query + ["-o", fmt], None, spec) for fmt in ("bed", "bedpe", "paf")
        for spec in ("device", "host", "auto")]
partition = ["partition", "-a", sys.argv[2], "-w", "1000", "-d", "100",
             "--min-missing-size", "200", "--min-boundary-distance", "200"]
refine = ["refine", "-a", sys.argv[2], "-r", "ref:500-2500", "-d", "100",
          "-x", "--max-extension", "0.5", "--extension-step", "500"]
runs += [(query + ["--approximate", "-o", "bed"], None, "device"),
         (stats, None, "device"), (stats[:3] + ["-b", bed], None, "device")]
runs += [(partition + ["--output-folder", "parts_" + fmt, "-o", fmt], None,
          "device") for fmt in ("bed", "paf")]
runs += [(refine, None, "device"),
         (query + ["-o", "bed"], "4096", "device"),
         (stats[:3] + ["-b", bed], "4096", "device"),
         (partition + ["--output-folder", "parts_paged"], "4096", "device")]
for argv, budget, spec in runs:
    if budget:  # pages the index
        os.environ["IMPG_HBM_BUDGET_BYTES"] = budget
    rc = impg_tpu_torch.cli.main(argv + ["--compute-engine", spec],
                                 device="cpu")
    assert rc == 0, argv
import impg_tpu_torch.commands.genotype
import impg_tpu_torch.genotype.core
import impg_tpu_torch.ops.diploid
import impg_tpu_torch.ops.syncmer_device
import impg_tpu_torch.syng.pack
fasta, reads = sys.argv[3], sys.argv[4]
for spec in ("device", "host"):
    steps = (
        ["syng", "-f", fasta, "-o", "pan_" + spec],
        ["map", "-a", "pan_%s.syngt" % spec, "-q", reads,
         "-O", "s_%s.packt" % spec],
        ["genotype", "cos", "-a", "pan_%s.syngt" % spec,
         "-p", "s_%s.packt" % spec, "-r", "hap0:0-5000"],
    )
    for argv in steps:
        rc = impg_tpu_torch.cli.main(argv + ["--compute-engine", spec],
                                     device="cpu")
        assert rc == 0, argv
import impg_tpu_torch.graph.sortgfa
import impg_tpu_torch.ops.path_sgd
for backend in ("numpy", "device"):
    out = "sorted_%s.gfa" % backend
    rc = impg_tpu_torch.cli.main(["sort", sys.argv[5], "--sgd-backend",
                                  backend, "--output", out], device="cpu")
    assert rc == 0, backend
    with open(out) as fh:
        assert fh.read().count("\nP\t") == 4, backend
import impg_tpu_torch.genotype.graph
import impg_tpu_torch.io.packbin
import impg_tpu_torch.syng.map
import impg_tpu_torch.syng.transitive
gfa, gfa_reads = sys.argv[5], sys.argv[6]
runs = (
    ["map", "-a", "pan_host.syngt", "-q", reads, "-o", "proj", "-O",
     "s.proj"],
    ["map", "-a", "pan_host.syngt", "-q", reads, "-o", "gaf", "-O", "s.gaf"],
    ["map", "-a", "pan_host.syngt", "-q", reads, "-o", "paf", "-O", "s.paf"],
    ["query", "-a", "pan_host.syngt", "-r", "hap0:0-3000", "-d", "100",
     "-x"],
    ["query", "-a", "pan_host.syngt", "-r", "hap0:0-3000", "-d", "100",
     "-o", "bedpe"],
    ["map", "--graph", gfa, "-q", gfa_reads, "-o", "graph-pack-tsv", "-O",
     "cov.tsv"],
    ["map", "--graph", gfa, "-q", gfa_reads, "-o", "gaf", "-O", "g.gaf"],
    ["map", "--graph", gfa, "-q", gfa_reads, "-o", "paf", "-O", "g.paf"],
    ["genotype", "cos", "--graph", gfa, "-q", gfa_reads,
     "--compute-engine", "device"],
    ["genotype", "cos", "--graph", gfa, "-q", gfa_reads,
     "--compute-engine", "host"],
)
for argv in runs:
    rc = impg_tpu_torch.cli.main(argv, device="cpu")
    assert rc == 0, argv
for name in ("s.gaf", "s.paf", "cov.tsv", "g.gaf", "g.paf",
             "s.proj/sample.gaf"):
    with open(name) as fh:
        assert fh.read().count("\n") > 3, name
chain_fa = sys.argv[7]
region = ["-a", sys.argv[2], "-r", "ref:500-2500", "-d", "100", "-x",
          "--sequence-files", chain_fa]
for argv in (["query", *region, "-o", "fasta"],
             ["query", *region, "-o", "gfa", "-O", "region.gfa"],
             ["query", *region, "-o", "vcf"],
             ["similarity", *region, "--pca"]):
    for spec in ("device", "native"):
        rc = impg_tpu_torch.cli.main(argv + ["--compute-engine", spec],
                                     device="cpu")
        assert rc == 0, argv
with open("region.gfa") as fh:
    assert fh.read().count("\nP\t") >= 3
import impg_tpu_torch.graph.crush
import impg_tpu_torch.graph.pggb
import impg_tpu_torch.graph.seqwish
syng_region = ["-a", "pan_host.syngt", "-r", "hap0:0-3000", "-d", "100",
               "-x", "--sequence-files", fasta]
for argv, out in (
        (["query", *region, "-o", "gfa", "--gfa-engine", "pggb", "-O",
          "pggb.gfa", "--compute-engine", "device"], "pggb.gfa"),
        (["query", *region, "-o", "gfa:sort:smooth:normalize:crush", "-O",
          "pipeline.gfa", "--compute-engine", "device"], "pipeline.gfa"),
        (["query", *syng_region, "-o", "bed", "-O", "syng.bed"], "syng.bed"),
        (["query", *syng_region, "-o", "gfa", "-O", "syng.gfa"], "syng.gfa")):
    rc = impg_tpu_torch.cli.main(argv, device="cpu")
    assert rc == 0, argv
    with open(out) as fh:
        assert fh.read().count("\n") >= 3, out
import impg_tpu_torch.io.onealn
import impg_tpu_torch.io.tpa
paf = sys.argv[2]
for argv, out in (
        (["export-1aln", "-a", paf, "--binary", "-o", "c.1aln"], "c.1aln"),
        (["export-tpa", "-a", paf, "-o", "c.tpa"], "c.tpa")):
    assert impg_tpu_torch.cli.main(argv, device="cpu") == 0, argv
    for extra in ([], ["--sequence-files", chain_fa, "-I"]):
        assert impg_tpu_torch.cli.main(
            ["query", "-a", out, "-r", "ref:500-2500", "-d", "100", "-x",
             "-O", "tp.bed", "--compute-engine", "device", *extra],
            device="cpu") == 0, out
        with open("tp.bed") as fh:
            assert fh.read().count("\n") >= 2, out
import impg_tpu_torch.commands.infer
import impg_tpu_torch.syng.gbwt
import impg_tpu_torch.syng.read_index
import impg_tpu_torch.syng.syng2gfa
runs = (
    (["query", "-a", paf, "-r", "ref:500-2500", "-d", "100", "-x", "-o",
      "gbwt", "-O", "region_paf", "--sequence-files", chain_fa,
      "--compute-engine", "device"], "region_paf.syngt"),
    (["query", "-a", "pan_host.syngt", "-r", "hap0:0-3000", "-d", "100",
      "-o", "gbwt", "-O", "region_syng", "--sequence-files", fasta],
     "region_syng.syngt"),
    (["read-index", "-q", reads, "-O", "r"], "r.readidx"),
    (["infer", "-a", "pan_host.syngt", "-p", "s_host.packt", "-r",
      "hap0:0-5000", "-w", "1000", "--gaf", "s.gaf", "--read-index",
      "r.readidx", "--read-link-weight", "0.5", "--write-haplotypes", "dip",
      "--sequence-files", fasta], "dip_hap1.fa"),
    (["syng2gfa", "-a", "pan_host.syngt", "--sequence-files", fasta, "-o",
      "pan.gfa"], "pan.gfa"),
    (["syng-repair", "pan_host.syngt", "--force"], "pan_host.syngt"))
for argv, out in runs:
    assert impg_tpu_torch.cli.main(argv, device="cpu") == 0, argv
    assert os.path.getsize(out) > 0, out
import impg_tpu_torch.commands.graph
import impg_tpu_torch.commands.project
import impg_tpu_torch.commands.render_translation
import impg_tpu_torch.graph.render_svg
import impg_tpu_torch.graph.vcf_lace
import impg_tpu_torch.io.agz
runs = (
    (["align", "-f", chain_fa, "-o", "aln.paf"], "aln.paf"),
    (["align", "-f", chain_fa, "--job-list", "-o", "jobs.txt"], "jobs.txt"),
    (["graph", "-f", chain_fa, "--gfa-engine", "pggb", "-o", "whole.gfa"],
     "whole.gfa"),
    (["graph", "-f", chain_fa, "--gfa-engine", "poa", "-o", "poa.gfa"],
     "poa.gfa"),
    (["graph", "-f", chain_fa, "-a", "aln.paf", "-o", "given.gfa"],
     "given.gfa"),
    (["graph", "-f", chain_fa, "--partition-size", "1000", "-d", "100",
      "-o", "parts.gfa"], "parts.gfa"),
    (["normalize", "region.gfa", "--output", "n.gfa"], "n.gfa"),
    (["normalize-self-loops", "region.gfa", "--output", "nsl.gfa"],
     "nsl.gfa"),
    (["smooth", "region.gfa", "--block-len", "400", "--output", "sm.gfa"],
     "sm.gfa"),
    (["crush", "region.gfa", "--output", "cr.gfa"], "cr.gfa"),
    (["render-graph", "region.gfa", "--output", "r.svg"], "r.svg"),
    (["lace", "--gfa-files", "region.gfa,pggb.gfa", "--output",
      "laced.gfa.gz"], "laced.gfa.gz"),
    (["agz", "create", chain_fa, "-o", "chain.agz"], "chain.agz"),
    (["render", "-a", paf, "-r", "ref:500-2500", "-d", "100", "-x",
      "--sequence-files", "chain.agz", "-O", "bundle", "--render-graph",
      "--gfa-engine", "pggb"], "bundle/render.svg"),
    (["project", "--gfa", gfa, "--gaf", "g.gaf", "-O", "p.proj"],
     "p.proj/sample.pack.tsv"),
    (["gfa2vcf", "region.gfa", "--sites", "flubbles"], None),
    (["graph-report", "region.gfa", "--flubbles", "--format", "json"], None),
    (["agz", "list", "chain.agz"], None),
    (["normalize-self-loops", "region.gfa", "--diagnose"], None))
for argv, out in runs:
    assert impg_tpu_torch.cli.main(argv, device="cpu") == 0, argv
    assert out is None or os.path.getsize(out) > 0, out
loaded = [m for m, mod in sys.modules.items() if blocked(m) and mod is not None]
assert not loaded, loaded
assert not tried, tried
print("NOJAX_OK", len(blocks[0]))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    rng = random.Random(5)
    text, _, _, seq_data = datagen.mutate_chain_paf(
        rng, n_seqs=4, seq_len=3000, return_sequences=True)
    paf = tmp_path / "chain.paf"
    paf.write_text(text)
    chain_fa = tmp_path / "chain.fa"
    datagen.write_fasta(str(chain_fa), seq_data)
    panel = synth.haplotype_panel(seed=4, n_haps=6, length=6000,
                                  n_founders=2)
    fasta, reads = tmp_path / "panel.fa", tmp_path / "reads.fq"
    synth.write_fasta(str(fasta), panel)
    synth.write_fastq(str(reads), synth.sample_reads(
        1, [panel[1][1], panel[4][1]], 600))
    gfa = tmp_path / "locus.gfa"
    gfa.write_text(synth.variation_graph(seed=2, n_haps=4, locus_len=5000))
    walks = Gfa.parse_python(gfa.read_text())
    spelled = [b"".join(walks.segments[s].encode() for s, _ in steps)
               for _, steps in walks.paths]
    gfa_reads = tmp_path / "locus_reads.fq"
    synth.write_fastq(str(gfa_reads), synth.sample_reads(
        3, [spelled[1], spelled[2]], 400))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(paf), str(fasta),
         str(reads), str(gfa), str(gfa_reads), str(chain_fa)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout
    bed_rows = [l for l in r.stdout.splitlines() if l.count("\t") == 5]
    assert len(bed_rows) > 1, r.stdout
    gt_rows = [l for l in r.stdout.splitlines() if l.startswith("sample\t")]
    assert len(gt_rows) >= 20, r.stdout  # two engines, top 10 each
    assert sum(l.startswith("#PCA\t") for l in r.stdout.splitlines()) >= 6
