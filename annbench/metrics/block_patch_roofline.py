"""K2 (block_patch) in the traced sub-window: its least time on the card
for the calls' arguments (annbench.roofline.k2_bound, recorded by the
benchmark's wrapper) over its kernels' device time."""

from annbench.roofline import k2_bound, least_seconds

LAYER = "kernels (ops/kernels)"
UNIT = "%"
MOVES = "recall_at_10"


def read(run):
    t, calls = run.trace, run.tracer.k2_calls if run.tracer else []
    if not t or not calls or run.peak is None:
        return None
    spent = sum(s for name, s in t["kernel_s"].items() if "block_patch" in name)
    if spent <= 0:
        return None
    least = sum(least_seconds(k2_bound(idx, blocks, nbytes), 0.0, run.peak)
                for idx, blocks, nbytes in calls)
    return 100.0 * least / spent
