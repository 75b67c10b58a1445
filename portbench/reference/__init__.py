"""Plain references that decide a run's `correct`.

Plain NumPy and Python (and plain torch where a reference runs on the
card).  Nothing here imports impg_tpu_torch, impg_tpu or JAX, and nothing
takes what the program built: each reference starts again from the data
the benchmark drew (alignment columns, PAF text, GFA text).
"""
