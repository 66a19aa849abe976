"""The operation and byte counts of the roofline and mfu metrics against
counts made by hand at LPCNetConfig() (GRU-A 384, GRU-B 16, cond 128,
256 levels)."""
import json
import os

from lpcbench import flops, harness

S = json.load(open(os.path.join(harness.HERE, "configs",
                                "lpcnet-384.json")))["lpcnet"]


def test_sample_flops_are_the_c_engines():
    # GRU-A recurrent 384x1152, GRU-B input 384x48 and recurrent 16x48,
    # dual FC 2 x 16x256: 469,760 multiply-adds
    assert flops.sample_flops(S) == 2 * 469_760


def test_frame_flops():
    # conv1 3 x 84x128, conv2 3 x 128x128, dense1/2 128x128, cond_a
    # 128x1152, cond_b 128x48
    macs = 3 * 84 * 128 + 3 * 128 * 128 + 2 * 128 * 128 + 128 * 1152 \
        + 128 * 48
    assert flops.frame_flops(S) == 2 * macs == 2 * 267_776


def test_plc_flops():
    # dense 57x128, GRU1 128x768 + 256x768, GRU2 2 x 256x768, out 256x20
    macs = 57 * 128 + 128 * 768 + 3 * 256 * 768 + 256 * 20
    assert flops.plc_flops({"dense_size": 128, "gru_size": 256}, 20) \
        == 2 * macs


def test_sample_loop_work_at_b1024_one_frame():
    w = flops.sample_loop_work(S, 1024, 1)
    assert w["flops"] == 2 * 469_760 * 160 * 1024
    weights = 3 * 256 * 1152 + 384 * 1152 + 1152 + 384 * 48 + 48 \
        + 16 * 48 + 48 + 2 * 16 * 256 + 4 * 256
    conds = 1024 * (1152 + 48 + 16)
    state = 1024 * (384 + 16 + 16 + 2 + 8)
    assert w["bytes"] == 4 * (weights + conds + 2 * state + 1024 * 160)
    least = flops.least_seconds(w)
    assert least["bound"] == "operations"
    assert abs(least["seconds"] - w["flops"] / 67e12) < 1e-12


def test_one_stream_frame_is_still_operation_bound():
    least = flops.least_seconds(flops.sample_loop_work(S, 1, 1))
    assert least["bound"] == "operations"
