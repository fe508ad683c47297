"""The 95th percentile of every request's latency in the window, each
timed from the moment it was due to the moment its answer was back, so a
stall counts against the requests queued behind it."""

from annbench.reference.exact import percentile

UNIT = "ms"


def read(run):
    lat = run.window["latencies"]
    return percentile(lat, 95) * 1e3 if lat else None
