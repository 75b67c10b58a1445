"""impg_tpu_torch — the PyTorch/CUDA port of impg_tpu's device engine.

The transitive query engine's device half (stab windows, lane projection,
compaction) and the region stab-count primitive run as hand-written CUDA
kernels for Hopper (csrc/, built with nvcc on first CUDA use, see
kernels.py); every kernel has a plain-torch twin that the CPU path and the
tests use.  Everything on the host — index build, PAF/BED I/O, the BFS
bookkeeping, the CLI — is impg_tpu's own numpy/C++ code, reused as is.

This package imports torch and never jax.
"""
