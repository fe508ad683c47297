"""The caller's host wall in ``ShardedGraphIndex._merged`` outside its
``MeshShards.walk`` calls, per search call of the window: the shards'
lists stacked and merged with dedup on card 0 and the answers fetched to
the host (the benchmark's host-clock spans around both calls; the merge's
own launch returns before the card has run it, so it is timed with the
fetch that waits for it)."""

from annbench.tracing import calls_and_spans

LAYER = "host orchestration (parallel/sharded.py)"
UNIT = "ms"
MOVES = "search_qps"


def read(run):
    calls, merged = calls_and_spans(run, "sharded.merged")
    _, walk = calls_and_spans(run, "mesh.walk")
    if not calls or not merged or not walk:
        return None
    return (sum(b - a for a, b in merged) - sum(b - a for a, b in walk)) * 1e3 / calls
