"""The port must run where neither JAX nor impg_tpu is installed, and must not
load either where they are: a fresh interpreter with `import jax` and `import
impg_tpu` blocked (names matched exactly, so impg_tpu_torch passes), and every
attempt recorded, imports the port and runs one small CPU query through the
engines (exact, approximate, paged) and through the CLI (`index`, `query -x`
bed/bedpe/paf, `--approximate`, paged, `stats -r/-b`, `partition -o bed|paf`
resident and paged, `refine -x`), then the syng path
`syng` -> `map` -> `genotype cos` on the device (CPU twins) and host
engines, and `sort` of a variation graph with the numpy and device (K-I's
twin) path-SGD backends."""

import os
import random
import subprocess
import sys

from impg_tpu_torch import synth
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
loaded = [m for m, mod in sys.modules.items() if blocked(m) and mod is not None]
assert not loaded, loaded
assert not tried, tried
print("NOJAX_OK", len(blocks[0]))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    rng = random.Random(5)
    text, _, _ = datagen.mutate_chain_paf(rng, n_seqs=4, seq_len=3000)
    paf = tmp_path / "chain.paf"
    paf.write_text(text)
    panel = synth.haplotype_panel(seed=4, n_haps=6, length=6000,
                                  n_founders=2)
    fasta, reads = tmp_path / "panel.fa", tmp_path / "reads.fq"
    synth.write_fasta(str(fasta), panel)
    synth.write_fastq(str(reads), synth.sample_reads(
        1, [panel[1][1], panel[4][1]], 600))
    gfa = tmp_path / "locus.gfa"
    gfa.write_text(synth.variation_graph(seed=2, n_haps=4, locus_len=5000))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(paf), str(fasta),
         str(reads), str(gfa)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout
    bed_rows = [l for l in r.stdout.splitlines() if l.count("\t") == 5]
    assert len(bed_rows) > 1, r.stdout
    gt_rows = [l for l in r.stdout.splitlines() if l.startswith("sample\t")]
    assert len(gt_rows) >= 20, r.stdout  # two engines, top 10 each
