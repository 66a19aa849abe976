"""The benchmark's tests: on the CPU at small sizes, and on the card
(marked cuda) at the cells' own sizes.

    python -m pytest lpcbench/tests -q            # the CPU tests
    python -m pytest lpcbench/tests -q -m cuda    # on a card
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# the tiny configuration of the CPU runs: every width cut, the shapes kept
TINY_LPCNET = {"gru_a_units": 48, "gru_b_units": 16, "cond_size": 32,
               "embed_sig_size": 16, "embed_pitch_size": 8}


@pytest.fixture
def tiny():
    """Overrides of each cell's configuration and traffic for a CPU run."""
    lp = {"weights": "init", "lpcnet": TINY_LPCNET}
    return {
        "synth-b1024": {"config": lp, "traffic": {
            "streams": 4, "frames_per_call": 2,
            "check": {"streams": 2, "calls": 1}}},
        "synth-stream-b1": {"config": lp, "traffic": {
            "check": {"streams": 1, "calls": 3}}},
        "plc-stream-b1": {"config": dict(lp, plc_weights="init", plc={
            "dense_size": 16, "gru_size": 16}),
            "traffic": {"check": {"calls": 3}}},
    }
