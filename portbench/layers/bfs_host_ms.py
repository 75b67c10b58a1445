"""Host BFS and visited bookkeeping (query/engine.py:_bfs_many_native over
native/visited.cpp), ms a batch: the batch's wall time less the time spent
inside the engine's `query_batch_stream`, both from the benchmark's own
wrappers.  Moves seeds_per_s."""


def read(ctx):
    walls = ctx.get("batch_walls")
    if not walls:
        return None
    return 1e3 * (sum(walls) - sum(ctx["batch_engine_s"])) / len(walls)
