"""The lower-precision controls of `correct`, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed, the control takes the program's place and is judged by the
cell's own comparison: a walk cell's reference walks with every coordinate
carried through bfloat16 (reference/walk.py, `coord="bf16"`) on the walks a
run would check first (one a batch, drawn as a run draws them), against the
exact reference; a sort cell's layout with its positions held in bfloat16
(reference/sort.py), its stress over the exact layout's, on the card.
Beside the control a sort cell reads, on the same pairs, a layout left at
its start positions (a fault the limit must catch) and the reference's
layout from another key of draws (a sound layout the limit must pass).
Prints one JSON line a seed with the numbers compared.  The benchmark's own
runs never run this; its readings set the ends of each limit (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench.harness import registry  # noqa: E402
from portbench.reference import sort as ref_sort  # noqa: E402
from portbench.reference import walk as ref_walk  # noqa: E402


def walk_table(cell, seed: int) -> ref_walk.DirectedTable:
    c = cell.config
    gen = registry.load_file("datagen", c["alignments"])
    chunks = list(gen.draw_chunks(seed, **gen.draw_params(c)))
    return ref_walk.DirectedTable(chunks, gen.seq_names(c["n_seqs"]),
                                  [c["seq_len"]] * c["n_seqs"])


def walk_control(cell, seed: int, batches: int) -> dict:
    drv = registry.load_file("drivers", "walk")
    table = walk_table(cell, seed)
    mix = cell.mix
    draw = np.random.default_rng([seed, 1])
    sample = np.random.default_rng([seed, 2])
    kw = drv.reference_args(mix)
    off = rows = 0
    for _ in range(min(batches, drv.CHECKED)):
        targets = drv.draw_batch(draw, table.lengths, int(mix["batch"]),
                                 mix["span_bp"])
        t, s, e = targets[int(sample.integers(len(targets)))]
        exact = table.walk(t, s, e, **kw)
        off += ref_walk.rows_off(table.walk(t, s, e, coord="bf16", **kw),
                                 exact)
        rows += exact.shape[0]
    return dict(rows_off=off, rows_checked=rows)


def sort_control(cell, seed: int, device) -> dict:
    text = cell.datagen("graph").make(cell.config, seed, "")["gfa"]
    g = ref_sort.Graph(text)
    ep, sp = int(cell.mix["epochs"]), int(cell.mix["samples_per_step"])
    pairs = ref_sort.stress_pairs(g, seed)
    s_ref = ref_sort.stress(ref_sort.layout_positions(g, ep, sp, device),
                            pairs)

    def ratio(x):
        return ref_sort.stress(x, pairs) / s_ref

    low = ref_sort.layout_positions(g, ep, sp, device,
                                    position_dtype=torch.bfloat16)
    other = ref_sort.layout_positions(g, ep, sp, device, key=43)
    return dict(layout_stress_ratio=ratio(low),
                unchanged=ratio(ref_sort.layout_inputs(g)[4]),
                other_key=ratio(other), segments=g.n_segs,
                steps=int(g.step_row.size))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--batches", type=int, default=8,
                    help="walk cells: the batches whose checked walk the "
                         "control answers")
    args = ap.parse_args(argv)
    cell = registry.Cell(registry.benchmark(), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        if cell.mix["driver"] == "sort":
            got = sort_control(cell, seed, device)
        else:
            got = walk_control(cell, seed, args.batches)
        got.update(workload=args.workload, seed=seed, control="bf16",
                   seconds=round(time.perf_counter() - t0, 3))
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
