#!/usr/bin/env python3
"""Time the paged engine's page build of one tree on the card.

    python3 chip_page_build.py [--root DIR] [--rounds R]

Builds chip_smoke.py's query index, realistic_directed_index(seed=3,
n_seqs=2000, seq_len=150_000, n_aln=250_000), with the impg_tpu_torch
package under DIR (default: this script's directory), plans its pages as
chip_smoke.py's `[4 paged]` does (a third of the lean bytes: 12 pages), and
builds every page R times in turn (the default, 2, gives that phase's 24
uploads).  Each round prints the host's seconds as the engine's
`page_build_s` counts them and the seconds to the uploads' end, with the
bytes sent.  The host's speed varies from call to call, so two trees are
compared in one call, alternating: a tree unpacked from `git archive` into
an ignored directory, then this one, this one and that one again.

It imports neither jax nor impg_tpu, and fails when no card is available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

N_ALN = 250_000  # chip_smoke.py's N_ALN
PAGED_SHARE = 3  # chip_smoke.py's PAGED_SHARE


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)), help="the tree whose impg_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_page_build: no CUDA device available")
    from impg_tpu_torch import synth
    from impg_tpu_torch.query.paged import TorchPagedEngine

    if any(m == "jax" or m.startswith(("jax.", "impg_tpu."))
           or m == "impg_tpu" for m in sys.modules):
        raise AssertionError("chip_page_build: jax or impg_tpu was imported")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    index = synth.realistic_directed_index(seed=3, n_seqs=2000,
                                           seq_len=150_000, n_aln=N_ALN)
    gen_s = time.perf_counter() - t0
    lean = index.arena.n_ops * 20 + len(index.records) * 36
    eng = TorchPagedEngine(index, dev, hbm_budget_bytes=lean // PAGED_SHARE)
    # One page built and dropped first, so that neither tree's first round
    # pays the pinned allocator's first requests alone.
    eng._build_page(0)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(args.rounds):
        eng.page_build_s, eng.h2d_bytes = 0.0, 0
        t0 = time.perf_counter()
        for p in range(eng.n_pages):
            page = eng._build_page(p)
            del page
        torch.cuda.synchronize()
        rounds.append(dict(page_build_s=round(eng.page_build_s, 3),
                           to_device_end_s=round(time.perf_counter() - t0, 3),
                           h2d_bytes=eng.h2d_bytes))
    print(smi, flush=True)
    print(json.dumps(dict(root=root, runs=int(index.arena.n_ops),
                          gen_s=round(gen_s, 1), pages=eng.n_pages,
                          rounds=rounds, mean_page_build_s=round(float(
                              np.mean([r["page_build_s"] for r in rounds])),
                              3))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
