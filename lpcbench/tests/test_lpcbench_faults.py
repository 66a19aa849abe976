"""A run with the timed path broken underneath comes out not correct, once
for each fault the cell can have; a sound run comes out correct. On the
CPU at small sizes (the program's plain loops), the harness's look for a
card skipped, every other part of a run driven."""
import pytest

from lpcbench import faults, harness

CASES = [("synth-b1024", None), ("synth-b1024", "unchanged"),
         ("synth-b1024", "token"), ("synth-b1024", "half"),
         ("synth-stream-b1", None), ("synth-stream-b1", "unchanged"),
         ("synth-stream-b1", "token"),
         ("plc-stream-b1", None), ("plc-stream-b1", "unchanged"),
         ("plc-stream-b1", "token")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_comes_out_not_correct(cell, fault, tiny):
    seconds = 0.5 if cell == "synth-b1024" else 4.0
    if fault is None:
        res = harness.run(cell, 21, seconds, False, device="cpu",
                          overrides=tiny[cell])
    else:
        with faults.plant(fault):
            res = harness.run(cell, 21, seconds, False, device="cpu",
                              overrides=tiny[cell])
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert res["correct"] == (fault is None), (res["checks"], failed)
