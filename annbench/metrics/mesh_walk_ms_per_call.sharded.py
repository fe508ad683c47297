"""The caller's host wall in ``MeshShards.walk`` per search call of the
window: the command out to every worker, the four shards' walks and
reranks, and the lists back to card 0 (the benchmark's host-clock span
around each call, `annbench.tracing.HostSpans`)."""

from annbench.tracing import calls_and_spans

LAYER = "mesh fan-out (parallel/mesh.py, parallel/sharded.py)"
UNIT = "ms"
MOVES = "search_qps"


def read(run):
    calls, walk = calls_and_spans(run, "mesh.walk")
    return sum(b - a for a, b in walk) * 1e3 / calls if calls and walk else None
