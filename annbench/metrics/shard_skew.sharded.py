"""The busiest card's device busy time over the cards' mean in the traced
sub-window (>= 1): how unevenly the partition spreads the walks."""

import statistics

LAYER = "device"
UNIT = "ratio"
MOVES = "search_qps"


def read(run):
    cards = run.trace and run.trace.get("cards")
    if not cards:
        return None
    busy = [c["busy_s"] for c in cards.values()]
    mean = statistics.fmean(busy)
    return max(busy) / mean if mean > 0 else None
