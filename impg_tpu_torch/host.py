"""The host half of the query path, named in one place.

The transitive BFS loop and its visited bookkeeping (query/engine.py over
native/visited.cpp), the native C++ reference engine (query/host_native.py)
and the index (index/impg_index.py) are the port's own copies of impg_tpu's
numpy and C++ modules; tests/test_torch_host.py holds each equal to its
original.
"""

from __future__ import annotations

from impg_tpu_torch.index.impg_index import ImpgIndex, load_or_build
from impg_tpu_torch.query.engine import (
    LEAN_FIELDS,
    LEAN_STATS_FIELDS,
    query_transitive_bfs_many,
)
from impg_tpu_torch.query.host_native import NativeHostEngine

__all__ = [
    "ImpgIndex",
    "LEAN_FIELDS",
    "LEAN_STATS_FIELDS",
    "NativeHostEngine",
    "load_or_build",
    "query_transitive_bfs_many",
]
