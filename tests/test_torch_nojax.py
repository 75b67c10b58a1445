"""The port must run where JAX is not installed, and must not start JAX where
it is: a fresh interpreter with `import jax` blocked, and every attempt
recorded, imports the port and runs one small CPU query through the engines
and through the CLI (exact and approximate, resident and paged, stats)."""

import os
import random
import subprocess
import sys

from tests import datagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
tried = []


class NoJax:
    # Any `import jax` raises ImportError and is recorded: code that catches
    # the error (a fallback for hosts without JAX) still counts.
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            tried.append(name)
            raise ImportError(f"blocked: {name}")


sys.meta_path.insert(0, NoJax())
sys.path.insert(0, sys.argv[1])
import impg_tpu_torch
import impg_tpu_torch.cli
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
query = ["query", "-a", sys.argv[2], "-r", "ref:500-2500", "-d", "100", "-x",
         "-o", "bed"]
stats = ["stats", "-a", sys.argv[2], "-r", "ref:500-2500"]
for argv, budget in ((query, None), (query + ["--approximate"], None),
                     (stats, None), (query, "4096"), (stats, "4096")):
    if budget:  # pages the index
        os.environ["IMPG_HBM_BUDGET_BYTES"] = budget
    rc = impg_tpu_torch.cli.main(argv + ["--compute-engine", "device"],
                                 device="cpu")
    assert rc == 0
loaded = [m for m, mod in sys.modules.items()
          if (m == "jax" or m.startswith("jax.")) and mod is not None]
assert not loaded, loaded
assert not tried, tried
print("NOJAX_OK", len(blocks[0]))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    rng = random.Random(5)
    text, _, _ = datagen.mutate_chain_paf(rng, n_seqs=4, seq_len=3000)
    paf = tmp_path / "chain.paf"
    paf.write_text(text)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(paf)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NOJAX_OK" in r.stdout
    bed_rows = [l for l in r.stdout.splitlines() if l.count("\t") == 5]
    assert len(bed_rows) > 1, r.stdout
