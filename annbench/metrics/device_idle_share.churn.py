"""The share of the traced sub-window in which the card ran no kernel and
no copy: 1 - busy / wall, busy the union of the device's spans."""

LAYER = "device"
UNIT = "%"
MOVES = "recall_at_10"


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t["busy_s"] / t["wall_s"]) if t and t["wall_s"] > 0 else None
