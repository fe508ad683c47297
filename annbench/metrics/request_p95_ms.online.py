"""The 95th percentile of every request's latency in the window, each
timed from the moment it was due to the moment its answer was back, so a
stall counts against the requests queued behind it.  Read per layer: the
host's speed from process to process spreads it by more than an
end-to-end bound may hold (PERF.md, section 2)."""

from annbench.reference.exact import percentile

LAYER = "host orchestration (graph/index.py)"
UNIT = "ms"
MOVES = "recall_at_10"


def read(run):
    lat = run.window["latencies"]
    return percentile(lat, 95) * 1e3 if lat else None
