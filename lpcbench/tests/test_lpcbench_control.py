"""The cells' controls on the card at the cells' own sizes: the reference
(or the program's own lower-precision path) in the program's place comes
out not correct. The readings that set the limits were taken with
`python3 -m lpcbench.control` over more seeds (PERF.md)."""
import pytest

from lpcbench import control

# seconds of a window that keeps as many calls as a run checks: the PLC
# control runs the plain reference in the program's place, ~0.75 s a call
SECONDS = {"synth-b1024": 10.0, "plc-stream-b1": 50.0,
           "synth-stream-b1": 3.0}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SECONDS))
def test_control_is_not_correct(cell, card):
    line = control.readings(cell, [31], SECONDS[cell], True)[0]
    assert not line["correct"], line
    assert line["numbers"]["calls_unchecked"] == 0, line
