"""The port must run where JAX is not installed (the CUDA machines carry no
JAX): a fresh interpreter with `import jax` blocked imports the port and runs
one small CPU query through the engine and through the CLI."""

import os
import random
import subprocess
import sys

from tests import datagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.path.insert(0, sys.argv[1])
import impg_tpu_torch
import impg_tpu_torch.cli
import impg_tpu_torch.query.device
import impg_tpu_torch.synth
from impg_tpu_torch.host import load_or_build
from impg_tpu_torch import host as engine
from impg_tpu_torch.query.device import TorchDeviceEngine

index = load_or_build([sys.argv[2]])
eng = TorchDeviceEngine(index, device="cpu")
rid = index.seq_index.get_id("ref")
blocks = engine.query_transitive_bfs_many(
    index, [(rid, 500, 2500)], max_depth=2, device_engine=eng, columnar=True
)
assert len(blocks[0]) > 1, len(blocks[0])
rc = impg_tpu_torch.cli.main(
    ["query", "-a", sys.argv[2], "-r", "ref:500-2500", "-d", "100", "-x",
     "-o", "bed", "--compute-engine", "device"], device="cpu",
)
assert rc == 0
loaded = [m for m, mod in sys.modules.items()
          if (m == "jax" or m.startswith("jax.")) and mod is not None]
assert not loaded, loaded
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
