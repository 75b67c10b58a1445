"""Each kernel's bytes and operations, counted from the cell's shapes.

The counts are fixed here, so a share reads the same work whatever
implements the kernel.  A byte is counted once where the function reads it
for a lane or query, and an output once where it is written; the peaks are
in harness/peaks.py.
"""
