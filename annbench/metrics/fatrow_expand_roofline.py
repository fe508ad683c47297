"""K1 (fatrow_expand) in the traced sub-window: its least time on the card
for the calls' arguments (annbench.roofline.k1_bound, recorded by the
benchmark's wrapper) over its kernels' device time."""

from annbench.roofline import k1_bound, least_seconds

LAYER = "kernels (ops/kernels)"
UNIT = "%"
MOVES = "search_qps"


def read(run):
    t, calls = run.trace, run.tracer.k1_calls if run.tracer else []
    if not t or not calls or run.peak is None:
        return None
    spent = sum(s for name, s in t["kernel_s"].items() if "fatrow_expand" in name)
    if spent <= 0:
        return None
    least = sum(least_seconds(*k1_bound(beam, rows, rp, dp), run.peak)
                for beam, rows, rp, dp in calls)
    return 100.0 * least / spent
