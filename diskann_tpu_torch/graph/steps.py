"""Stepping forms of the loops that end on a host decision.

The hop loop of `graph/search.py` and the occlusion scan of
`graph/prune.py` end when a device flag says so: no unexpanded entry is
left, no pool position is still eligible.  Each such loop is written once,
as a generator (``*_steps``): where it needs the decision it yields the
flag, a 0-d bool tensor on the loop's device, and receives the host's
answer (``flag.item()``) back; its return value is the call's result.
`graph/build.insert_batch_steps` and `graph/delete.patch_rows_steps`
compose them with ``yield from``.

`run` drives one generator to its end in the calling thread, which is
what every public function does (`beam_search`, `robust_prune`,
`insert_batch`, ...): one device, the same ops in the same order.
`parallel/sharded._fan_out` drives one generator per shard in lockstep:
it advances every shard to its next flag, so each card's step is queued
before the host waits on any flag, then reads the flags together.  Each
read is a ``sync`` wait of `trace.py`.
"""

from __future__ import annotations

from diskann_tpu_torch.trace import wait


def run(steps):
    """Drive a stepping generator to its end, answering each yielded flag
    with its host value; returns the generator's return value."""
    try:
        flag = next(steps)
        while True:
            with wait("sync"):
                answer = flag.item()
            flag = steps.send(answer)
    except StopIteration as stop:
        return stop.value
