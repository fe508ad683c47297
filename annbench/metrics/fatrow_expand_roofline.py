"""K1 (fatrow_expand) in the traced sub-window: its least time on the card
for the calls' arguments (annbench.roofline.k1_bound, recorded by the
benchmark's wrapper; on a mesh, by each worker's, and the time summed over
the cards) over its kernels' device time."""

from annbench.roofline import least_seconds

LAYER = "kernels (ops/kernels)"
UNIT = "%"
MOVES = "search_qps"


def read(run):
    t = run.trace
    if not t or not t["k1_bounds"] or run.peak is None:
        return None
    spent = sum(s for name, s in t["kernel_s"].items() if "fatrow_expand" in name)
    if spent <= 0:
        return None
    return 100.0 * sum(least_seconds(b, ops, run.peak) for b, ops in t["k1_bounds"]) / spent
