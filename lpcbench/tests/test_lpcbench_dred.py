"""The cell dred-encode-b1024 (DREDCodec.step): a sound run comes out
correct and one with the step broken underneath does not, on the CPU at
a small geometry; the work counted against a hand count at the published
widths; the inputs from the seed; the TF32 control on the card."""
import os
import subprocess
import sys

import pytest
import torch

from lpcbench import control, harness, rdovae_flops

CELL = "dred-encode-b1024"
TINY = {"config": {"rdovae": {"cond_size": 32, "cond_size2": 16}},
        "traffic": {"streams": 4, "setup_dframes": 16,
                    "check": {"streams": 2, "calls": 4}}}


def _broken(fault):
    """DREDCodec.step with `fault` underneath: "unchanged" leaves the
    state as it was given, "symbol" moves one payload symbol of every
    stream by 1, "latent" moves one latent of every stream by 1e-3."""
    from lpcnet_tpu_torch.dred import DREDCodec
    orig = DREDCodec.step

    def step(self, state, feats):
        before = {k: v.clone() for k, v in state.tensors.items()}
        out = orig(self, state, feats)
        if fault == "unchanged":
            for k, v in before.items():
                state.tensors[k].copy_(v)
            return out
        key, by = {"symbol": ("symbols", 1),
                   "latent": ("latents", 1e-3)}[fault]
        out[key][:, :, 0] += by
        return out
    return step


@pytest.mark.parametrize("fault", [None, "unchanged", "symbol", "latent"])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    from lpcnet_tpu_torch.dred import DREDCodec
    if fault:
        monkeypatch.setattr(DREDCodec, "step", _broken(fault))
    res = harness.run(CELL, 2 ** 31 + 21, 1.0, False, device="cpu",
                      overrides=TINY)
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert res["correct"] == (fault is None), (res["checks"], failed)
    assert res["checks"]["calls_unchecked"]["value"] == 0
    assert set(res["metrics"]) == {"audio_rtf", "setup_s"}


def test_flops_are_the_hand_count():
    r = harness.cell_parts(CELL)[1]["rdovae"]
    # a pair: dense1 40x256, three GRUs 256x3072 + 1024x3072, dense3 and
    # dense5 1024x256, dense7 and dense8 1024x1024; the conv 4 x 5888x80;
    # the state head 5888x128 + 128x24
    pair = 40 * 256 + 3 * (256 * 3072 + 1024 * 3072) + 2 * 1024 * 256 \
        + 2 * 1024 * 1024
    assert pair == 14_428_160
    assert rdovae_flops.dframe_macs(r) == 2 * pair + 4 * 5888 * 80 \
        + 5888 * 128 + 128 * 24 == 31_497_216
    w = rdovae_flops.encoder_work(r, 1024, 1)
    assert w["flops"] == 2 * 31_497_216 * 1024
    assert w["bytes"] < w["flops"] / 67e12 * 3.35e12     # operation-bound


def test_inputs_from_the_seed():
    """A cell set up twice with one seed feeds the program the same
    features; another seed other features, of the same sizes."""
    _, config, traffic, _, driver = harness.cell_parts(CELL)

    def inputs(seed):
        ctx = {"config": harness._merge(config, TINY["config"]),
               "traffic": harness._merge(traffic, TINY["traffic"]),
               "seed": seed, "seconds": 1.0, "device": torch.device("cpu"),
               "root": harness.ROOT, "control": False}
        cell = driver.setup(ctx)
        return torch.stack(cell.blocks), cell.rows
    (a, ra), (b, rb), (c, _) = inputs(11), inputs(11), inputs(2 ** 31 + 5)
    assert torch.equal(a, b) and torch.equal(ra, rb)
    assert a.shape == c.shape == (50, 4, 4, 20) and not torch.equal(a, c)


def test_a_run_of_the_cell_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import lpcbench.harness, lpcnet_tpu_torch.dred\n"
            "lpcbench.harness.load_module(\n"
            "    lpcbench.harness.HERE + '/drivers/dred.py', 'dred')\n"
            "print(lpcbench.harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_tf32_control_is_not_correct(card):
    line = control.readings(CELL, [2 ** 31 + 31], 10.0, True)[0]
    assert not line["correct"], line
    assert line["numbers"]["calls_unchecked"] == 0, line
