"""Per-layer metric readers, one file a metric, named as the metric.

Each holds `read(ctx) -> float | None`.  `ctx` holds what the cell's driver
recorded in the traced run (its spans and counts) and `trace`, the window's
harness/trace.py:DeviceTrace.  A reader that finds nothing to read returns
None, and the metric is left out of the line; a share of a roofline is never
0 for want of a reading.
"""
