"""control.py for a walk cell whose alignments are its configuration's one
panel, at the cell's own size.

    python3 portbench/control_panel.py --workload <name> --seeds <n> [<n> ...] \
        --batches 24

control.py builds a walk cell's reference table from drawn chunks over
sequences of one length.  A panel's generator (datagen/panel_ava.py) draws
the same alignments in every run, over haplotypes that differ in length,
and hands them over with `reference_data(config)`.  This entry point gives
control.py that table, built once since no seed changes it, and otherwise
runs control.py as it is: the same draws of the walks a run checks first,
the same bfloat16 walks against the exact ones, one JSON line a seed.
"""

from __future__ import annotations

import contextlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import control  # noqa: E402
from portbench.reference import walk as ref_walk  # noqa: E402


def panel_table(cell, seed: int = 0) -> ref_walk.DirectedTable:
    """The reference's record table of the cell's panel; `seed`, which
    control.py passes, changes nothing."""
    table = getattr(cell, "panel_table", None)
    if table is None:
        gen = cell.datagen("alignments")
        table = ref_walk.DirectedTable(*gen.reference_data(cell.config))
        cell.panel_table = table
    return table


@contextlib.contextmanager
def panel_tables():
    """control.py's walks over the panel's table while the block runs."""
    drawn = control.walk_table
    control.walk_table = panel_table
    try:
        yield
    finally:
        control.walk_table = drawn


def walk_control(cell, seed: int, batches: int) -> dict:
    with panel_tables():
        return control.walk_control(cell, seed, batches)


def main(argv=None) -> int:
    with panel_tables():
        return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
