"""The host half of the query path, which the port reuses from impg_tpu.

The transitive BFS loop and its visited bookkeeping (query/engine.py over
native/visited.cpp), the native C++ reference engine and the index are
impg_tpu's numpy and C++ modules, used as they are; none of them imports JAX
(tests/test_torch_nojax.py holds that).  They are named here so that a
caller of the port imports only impg_tpu_torch.
"""

from __future__ import annotations

from impg_tpu.index.impg_index import ImpgIndex, load_or_build
from impg_tpu.query.engine import (
    LEAN_FIELDS,
    LEAN_STATS_FIELDS,
    query_transitive_bfs_many,
)
from impg_tpu.query.host_native import NativeHostEngine

__all__ = [
    "ImpgIndex",
    "LEAN_FIELDS",
    "LEAN_STATS_FIELDS",
    "NativeHostEngine",
    "load_or_build",
    "query_transitive_bfs_many",
]
