"""Engine glue (query/device.py: DepthFront, query_batch_stream: K-B's
round trip, chunking, the n_hits read, the D2H copy), ms a batch: the host
time spent inside the engine's stream, from the benchmark's proxy around the
engine.  Moves seeds_per_s."""


def read(ctx):
    walls = ctx.get("batch_walls")
    if not walls:
        return None
    return 1e3 * sum(ctx["batch_engine_s"]) / len(walls)
