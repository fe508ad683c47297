"""Device time of the kernels launched inside the port's ``search.rerank``
spans (the float32 rerank of the walk's candidates: `graph/index._rerank`)
per 1,000 queries of the traced sub-window."""

LAYER = "host orchestration (graph/index.py)"
UNIT = "ms"
MOVES = "search_qps"


def read(run):
    t = run.trace
    s = t and t["ranges_device_s"].get("search.rerank")
    return s * 1e3 / (run.tracer.queries / 1e3) if s and run.tracer.queries else None
