"""impg_tpu_torch — the PyTorch/CUDA port of impg_tpu's query path.

The transitive query engine's device half (stab windows, lane projection,
compaction) and the region stab-count primitive run as hand-written CUDA
kernels for Hopper (csrc/, built with nvcc on first CUDA use, see
kernels.py); every kernel has a plain-torch twin that the CPU path and the
tests use.  The host half — index build, PAF/BED I/O, the BFS bookkeeping,
the writers — is the port's own copy of impg_tpu's numpy and C++ modules
(core/, io/, index/, ops/projection_np.py, query/engine.py and its
neighbours, native/), and cli.py is the port's own `index`/`query`/`stats`.

This package imports torch and never jax, and nothing of impg_tpu.
"""
