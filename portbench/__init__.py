"""The benchmark of impg_tpu_torch on NVIDIA H100 cards.

`run.py` runs one cell of BENCHMARK.json once.  Everything that belongs to
one configuration, traffic mix, per-layer metric or kernel lives in a file
of its own that the harness finds by name:

  configs/<config>.json     the sizes, their source and what was cut
  datagen/<generator>.py    the draws of a configuration's data
  mixes/<traffic>.json      the parameters of a traffic mix
  drivers/<driver>.py       the loop a mix names, over the program's entry
  layers/<metric>.py        the reader of one per-layer metric
  roofline/<kernel>.py      a kernel's bytes and operations from shapes
  reference/                the plain references that decide `correct`

Nothing here imports JAX or the JAX package; `reference/` imports nothing
of impg_tpu_torch either.
"""
