"""On the card, at a size a test run holds: the port's run comes out
correct and the control (the exact search in TF32 in the port's place)
does not.  The control at the cells' own sizes is `annbench/control.py`."""

import functools
import time

import pytest

from annbench import manifest, run
from annbench.reference.flat import Exact
from small import SMALL

BENCH = manifest.Bench()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_port_correct_and_control_not_on_the_card(card, cell):
    kw = dict(seed=2**31 + 5, seconds=0.5, trace=True, device=card,
              overrides=SMALL[cell])
    res, rows = run.run_cell(BENCH, cell, t0=time.perf_counter(), **kw)
    assert res["correct"], rows
    assert res["device"]["busy_s"] > 0
    res, rows = run.run_cell(BENCH, cell, t0=time.perf_counter(),
                             make_system=functools.partial(Exact, precision="tf32"), **kw)
    assert not res["correct"]
