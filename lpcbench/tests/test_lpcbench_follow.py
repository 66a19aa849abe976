"""The reference's sample loop gives the same bits replayed as a CUDA graph
as it does run step by step, at the cells' widths, sampling on its own,
following a program's output, and teacher-forced as the PLC check runs
it."""
import pytest
import torch

from lpcbench import harness
from lpcbench.reference import sample_check, weights
from lpcbench.reference.frozen.models import lpcnet as ref_lpcnet

SIZES = harness.cell_parts("synth-b1024")[1]["lpcnet"]


def _both(monkeypatch, *args, **kw):
    graphed = sample_check.follow(*args, **kw)
    monkeypatch.setattr(sample_check, "WARM_STEPS", 10 ** 9)
    stepped = sample_check.follow(*args, **kw)
    monkeypatch.undo()
    return graphed, stepped


def _same(a, b):
    (sa, oa, ka), (sb, ob, kb) = a, b
    assert ka == kb
    assert torch.equal(oa, ob)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.cuda
def test_graphed_loop_is_the_stepped_loop(card, monkeypatch):
    cfg = ref_lpcnet.LPCNetConfig(**SIZES)
    params = weights.draw(weights.lpcnet_spec(SIZES), 3, card)
    tb = sample_check.tables(params, cfg)
    R, T = 16, 2
    gen = torch.Generator(card).manual_seed(3)
    feats = 0.3 * torch.randn((R, T, 36), generator=gen, device=card)
    c = ref_lpcnet.frame_conditions(params, feats, cfg, tb)
    conds = {k: c[k] for k in ("cond_a", "cond_b", "lpc")}
    state = sample_check.init_state(R, cfg, card)
    free = _both(monkeypatch, tb, cfg, state, conds, None)
    _same(*free)
    out = free[0][1].clone()
    out[:, 37] += 3.0
    _same(*_both(monkeypatch, tb, cfg, state, conds, out))
    n = T * cfg.frame_size
    forced = torch.rand((R, n), generator=gen, device=card) < 0.3
    tol = 1.0 + 2.0 * torch.rand((R, n), generator=gen, device=card)
    _same(*_both(monkeypatch, tb, cfg, state, conds, out, target=out,
                 forced=forced, tol=tol))
