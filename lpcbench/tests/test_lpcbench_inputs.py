"""Every input generator gives the same inputs for the same seed and other
inputs for another seed, with the same sizes."""
import numpy as np
import pytest
import torch

from lpcbench import harness
from lpcbench.drivers import plc as plc_driver
from lpcbench.reference import weights
from conftest import TINY_LPCNET

SIZES = dict(harness.cell_parts("synth-b1024")[1]["lpcnet"], **TINY_LPCNET)


def _same(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(sorted(weights_leaves(a)), sorted(weights_leaves(b))))


def weights_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from weights_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v


def test_weights_from_the_seed():
    spec = weights.lpcnet_spec(SIZES)
    a, b = weights.draw(spec, 5, "cpu"), weights.draw(spec, 5, "cpu")
    c = weights.draw(spec, 6, "cpu")
    assert _same(a, b) and not _same(a, c)
    assert a["gru_a"]["wr"].shape == (48, 144)
    wr = a["gru_a"]["wr"].reshape(48, 3, 48).permute(1, 0, 2)
    eye = torch.eye(48).expand(3, 48, 48)
    assert torch.allclose(wr @ wr.transpose(1, 2), eye, atol=1e-5)


def test_loss_pattern_from_the_seed():
    mix = harness.cell_parts("plc-stream-b1")[2]

    def draw(seed):
        return plc_driver.loss_pattern(np.random.default_rng(seed), 20000,
                                       mix["loss"])
    a, b, c = draw(3), draw(3), draw(4)
    assert (a == b).all() and not (a == c).all()
    assert not a[:mix["loss"]["lead"]].any()
    assert 0.17 < a.mean() < 0.23 and 0.17 < c.mean() < 0.23
    runs = np.diff(np.flatnonzero(np.diff(np.r_[0, a.astype(int), 0])))
    assert runs[::2].max() <= 3          # bursts of 1-3 lost frames


@pytest.mark.parametrize("cell", ["synth-b1024", "plc-stream-b1"])
def test_stream_inputs_from_the_seed(cell, tiny):
    """A cell set up twice with one seed feeds the program the same
    frames; another seed other frames, of the same sizes."""
    _, config, traffic, _, driver = harness.cell_parts(cell)
    over = tiny[cell]

    def inputs(seed):
        ctx = {"config": harness._merge(config, over["config"]),
               "traffic": harness._merge(traffic, over["traffic"]),
               "seed": seed, "seconds": 1.0, "device": torch.device("cpu"),
               "root": harness.ROOT, "control": False}
        c = driver.setup(ctx)
        if cell == "synth-b1024":
            return torch.stack(c.blocks)
        return torch.stack(c.frames[:8]), c.lost[:64]
    a, b, c = inputs(11), inputs(11), inputs(12)
    flat = (lambda x: torch.cat([t.flatten().float() for t in x])
            if isinstance(x, tuple) else x)
    assert torch.equal(flat(a), flat(b))
    assert flat(a).shape == flat(c).shape and not torch.equal(flat(a),
                                                               flat(c))
