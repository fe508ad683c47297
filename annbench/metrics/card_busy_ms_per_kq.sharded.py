"""The busiest card's device busy time per 1,000 queries of the traced
sub-window: the union of its kernel and copy spans, from its mesh
worker's own trace (the walk, the rerank, the copies of the queries in and
the lists out; on card 0 the caller's merge too)."""

LAYER = "device"
UNIT = "ms"
MOVES = "search_qps"


def read(run):
    cards = run.trace and run.trace.get("cards")
    if not cards or not run.tracer.queries:
        return None
    busy = max(c["busy_s"] for c in cards.values())
    return busy * 1e3 / (run.tracer.queries / 1e3) if busy > 0 else None
