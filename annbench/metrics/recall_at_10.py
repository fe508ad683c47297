"""Mean recall@10 of every query the window answered, against the exact
top-10 over the rows live when it was answered (the reference's)."""

UNIT = "recall"


def read(run):
    return run.numbers.get("recall_at_10")
