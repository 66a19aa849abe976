"""The CUDA kernels (the sample loop's, Burg's cepstral analysis, LPC from
the cepstrum) against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch finds no CUDA device. This file
imports neither jax nor lpcnet_tpu, so it also runs on a machine with the
card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The sample loop's two launch plans are forced through launch_plan's input,
the card's cluster count (sample_cuda._plan_forced): the card's own count
gives plan L up to its boundary (8 streams per cluster), 0 gives plan T.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
from lpcnet_tpu_torch.vocoder import Synthesizer

FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)
# the argument sets the PLC engines pass to synth_samples: (nsamples,
# target, preload, force_from, n_active)
FLAG_SETS = {
    "free80": (80, False, False, False, False),
    "target": (160, True, False, False, False),
    "target_preload": (160, True, True, False, False),
    "target_force_from": (160, True, False, True, False),
    "target_force_from_n_active": (160, True, False, True, True),
    "n_active": (160, False, False, False, True),
    # the strict engine's three: catch-up over the delay buffer, the 80/80
    # split conceal and the blend continuation, the forced blend
    "strict_catchup": (160, True, True, False, True),
    "strict_free80": (80, False, False, False, True),
    "strict_blend80": (80, True, True, False, True),
}


# (plan, batch) of the sample-loop cases; "boundary" is 8 x the card's
# cluster count, the largest batch of plan L
PLAN_CASES = [("L", 1), ("L", 7), ("L", 9), ("L", "boundary"), ("T", 1),
              ("T", 7), ("T", 9), ("T", "boundary"), ("T", "boundary+1"),
              ("T", 130)]
PLAN_IDS = [f"{p}-B{b}" for p, b in PLAN_CASES]
_plain = {}   # plain results, shared by the cases of both plans


def _batch(card, batch):
    """A batch of PLAN_CASES as a number of streams."""
    edge = sample_cuda.TILE * sample_cuda.max_clusters(card)
    return {"boundary": edge, "boundary+1": edge + 1}.get(batch, batch)


def _plain_once(key, fn):
    if key not in _plain:
        _plain[key] = fn()
    return _plain[key]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _setup(card, batch, variant="flat", warm=True):
    """Shipped weights, one frame of conditions per stream, and a state
    warmed by a frame of free-run synthesis so that no leaf is trivial."""
    voc = Synthesizer(device=card, variant=variant)
    offs = (5 * np.arange(batch)) % (len(FEATS) - 2)
    f = np.stack([FEATS[o:o + 2] for o in offs])
    conds = voc.conditions(f)
    state = voc.reset(batch, per_stream_rng=True)
    if warm:
        state, _ = sample_cuda.synthesize_frames(
            voc.tables, state, {k: conds[k][:, :1].contiguous()
                                for k in ("cond_a", "cond_b", "lpc")},
            voc.cfg, variant=variant)
    cond = {k: conds[k][:, 1].contiguous()
            for k in ("cond_a", "cond_b", "lpc")}
    return voc, conds, state, cond


def _flag_args(name, batch, device, seed=3, ns=None):
    ns0, has_target, has_pre, has_ff, has_act = FLAG_SETS[name]
    ns = ns0 if ns is None else ns
    rs = np.random.RandomState(seed)
    i32 = dict(dtype=torch.int32, device=device)
    kw = {}
    if has_target:
        kw["target"] = torch.as_tensor(
            np.round(rs.randn(batch, ns) * 2500).astype(np.float32),
            device=device)
    if has_pre:
        kw["preload"] = torch.as_tensor(rs.randint(0, ns + 1, batch), **i32)
    if has_ff:
        kw["force_from"] = torch.as_tensor(rs.randint(40, ns + 1, batch),
                                           **i32)
    if has_act:
        kw["n_active"] = torch.as_tensor(rs.randint(0, ns + 1, batch), **i32)
    return ns, kw


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "base"])
@pytest.mark.parametrize("plan,batch", PLAN_CASES, ids=PLAN_IDS)
def test_kernel_bit_identical_to_plain(card, variant, plan, batch):
    """Same state, conditions and shipped weights: the kernel sums in the
    plain version's order, so pcm and the whole state agree exactly under
    either plan; ragged tiles (7, 9, 130 streams), a last cluster of plan T
    only partly filled, and plan L's largest batch included."""
    batch = _batch(card, batch)
    voc, conds, state, _ = _setup(card, batch, variant, warm=False)
    before = sample_cuda.launches[variant]
    with sample_cuda._plan_forced(card, plan):
        st_k, pcm_k = sample_cuda.synthesize_frames(
            voc.tables, state, conds, voc.cfg, variant=variant)
    torch.cuda.synchronize()
    assert sample_cuda.launches[variant] == before + 2
    assert sample_cuda.last_plan[0] == plan
    st_p, pcm_p = _plain_once(
        ("frames", variant, batch),
        lambda: sample_scan.synthesize_frames(voc.tables, state, conds,
                                              voc.cfg,
                                              flat=variant == "flat"))
    assert torch.equal(pcm_k, pcm_p)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fuse", "opt"])
@pytest.mark.parametrize("plan,batch", PLAN_CASES, ids=PLAN_IDS)
def test_fused_kernel_bit_identical_to_plain_and_base(card, variant, plan,
                                                      batch):
    """K5 over 2 frames under either plan: pcm and every state leaf equal to
    its plain version's (synthesize_frames_opt) and to the walked-tree
    kernel's (K2) on the same inputs under the same plan; ragged tiles and
    plan L's largest batch included."""
    batch = _batch(card, batch)
    voc, conds, state, _ = _setup(card, batch, "base", warm=False)
    before = dict(sample_cuda.launches)
    plans_before = dict(sample_cuda.plan_launches)
    with sample_cuda._plan_forced(card, plan):
        st_k, pcm_k = sample_cuda.synthesize_frames(voc.tables, state, conds,
                                                    voc.cfg, variant=variant)
        torch.cuda.synchronize()
        assert sample_cuda.last_plan[0] == plan
        after = dict(sample_cuda.launches)
        assert after.pop(variant) == before.pop(variant) + 2
        assert after == before
        assert sample_cuda.plan_launches[plan] == plans_before[plan] + 2
        st_b, pcm_b = sample_cuda.synthesize_frames(voc.tables, state, conds,
                                                    voc.cfg, variant="base")
    st_p, pcm_p = _plain_once(
        ("fused", variant, batch),
        lambda: sample_scan.synthesize_frames_opt(
            voc.tables, state, conds, voc.cfg, pipeline_thr=variant == "opt"))
    assert pcm_k.shape == (batch, 320)
    assert torch.equal(pcm_k, pcm_p) and torch.equal(pcm_k, pcm_b)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k
        assert torch.equal(st_k[k], st_b[k]), k


def _widened(tables):
    """The float32 tables dict of bf16 tables: each table widened."""
    out = {k: v for k, v in tables.items() if not k.startswith("fused")}
    out.update({k: tables[k].float() for k in sample_scan.TABLES})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sample_cuda.FRAME_VARIANTS)
@pytest.mark.parametrize("plan,batch", PLAN_CASES, ids=PLAN_IDS)
def test_bf16_kernel_bit_identical_to_plain_and_f32_kernel(card, variant,
                                                           plan, batch):
    """The bf16 instance of each frame kernel (K1 flat, K2 base, K5 fuse
    and opt) over 2 frames under either plan: pcm and every state leaf
    equal to the plain loop's on the same bf16 tables and to the float32
    instance's on those tables widened, exactly (it widens each element
    and keeps the sum's order); counted under <variant>_bf16 alone."""
    batch = _batch(card, batch)
    voc, conds, state, _ = _setup(card, batch, warm=False)
    tb = sample_scan.bf16_tables(voc.tables)
    before = dict(sample_cuda.launches)
    with sample_cuda._plan_forced(card, plan):
        st_k, pcm_k = sample_cuda.synthesize_frames(tb, state, conds,
                                                    voc.cfg, variant=variant)
        torch.cuda.synchronize()
        assert sample_cuda.last_plan[0] == plan
        after = dict(sample_cuda.launches)
        assert after.pop(variant + "_bf16") \
            == before.pop(variant + "_bf16") + 2
        assert after == before
        st_w, pcm_w = sample_cuda.synthesize_frames(
            _widened(tb), state, conds, voc.cfg, variant=variant)
    if variant in ("fuse", "opt"):
        plain = lambda: sample_scan.synthesize_frames_opt(
            tb, state, conds, voc.cfg, pipeline_thr=variant == "opt")
    else:
        plain = lambda: sample_scan.synthesize_frames(
            tb, state, conds, voc.cfg, flat=variant == "flat")
    st_p, pcm_p = _plain_once(("bf16", variant, batch), plain)
    assert torch.equal(pcm_k, pcm_p) and torch.equal(pcm_k, pcm_w)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k
        assert torch.equal(st_k[k], st_w[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flat", "base"])
@pytest.mark.parametrize("plan,batch", PLAN_CASES, ids=PLAN_IDS)
@pytest.mark.parametrize("ns", [80, 160])
@pytest.mark.parametrize("flags", list(FLAG_SETS))
def test_synth_samples_bit_identical_to_plain(card, flags, ns, plan, batch,
                                              variant):
    """K3 on every argument set the engines pass, at 80 and 160 samples,
    under either plan: one launch, and pcm and every state leaf equal to
    the plain loop's."""
    batch = _batch(card, batch)
    voc, _, state, cond = _setup(card, batch, variant)
    ns, kw = _flag_args(flags, batch, card, ns=ns)
    before = dict(sample_cuda.launches)
    with sample_cuda._plan_forced(card, plan):
        st_k, pcm_k = sample_cuda.synth_samples(
            voc.tables, state, cond, voc.cfg, ns, variant=variant, **kw)
    torch.cuda.synchronize()
    assert sample_cuda.last_plan[0] == plan
    after = dict(sample_cuda.launches)
    assert after.pop("tf_" + variant) == before.pop("tf_" + variant) + 1
    assert after == before
    st_p, pcm_p = _plain_once(
        ("synth", variant, flags, ns, batch),
        lambda: sample_scan.synth_samples(voc.tables, state, cond, voc.cfg,
                                          ns, flat=variant == "flat", **kw))
    assert pcm_k.shape == (batch, ns)
    assert torch.equal(pcm_k, pcm_p)
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("plan,batch", PLAN_CASES, ids=PLAN_IDS)
@pytest.mark.parametrize("ns", [80, 160])
def test_teacher_advance_bit_identical_to_plain_and_forced_k3(card, ns, plan,
                                                              batch):
    """K4 under either plan, one launch: all six state fields equal to its
    plain version's (sample_scan.teacher_advance: teacher_sequences, the
    GRU recurrences, the KISS99 jump) and to a fully forced K3 launch's
    under the same plan."""
    batch = _batch(card, batch)
    voc, _, state, cond = _setup(card, batch)
    _, kw = _flag_args("target", batch, card, ns=ns)
    before = dict(sample_cuda.launches)
    plans_before = dict(sample_cuda.plan_launches)
    with sample_cuda._plan_forced(card, plan):
        st_k, out = sample_cuda.teacher_advance(voc.tables, state, cond,
                                                voc.cfg, kw["target"])
        torch.cuda.synchronize()
        assert sample_cuda.last_plan[0] == plan
        after = dict(sample_cuda.launches)
        assert after.pop("teacher") == before.pop("teacher") + 1
        assert after == before
        assert sample_cuda.plan_launches[plan] == plans_before[plan] + 1
        st_3, pcm_3 = sample_cuda.synth_samples(voc.tables, state, cond,
                                                voc.cfg, ns,
                                                target=kw["target"])
    assert out is kw["target"]
    assert torch.equal(pcm_3, kw["target"])
    st_p, _ = _plain_once(
        ("teacher", ns, batch),
        lambda: sample_scan.teacher_advance(voc.tables, state, cond, voc.cfg,
                                            kw["target"]))
    assert set(st_k) == set(st_p) == {"gru_a", "gru_b", "last_sig",
                                      "last_exc", "deemph", "rng"}
    for k in st_p:
        assert torch.equal(st_k[k], st_p[k]), k
        assert torch.equal(st_k[k], st_3[k]), k


@pytest.mark.cuda
def test_plan_l_over_the_cluster_count_raises(card, monkeypatch):
    """A plan-L launch with more tiles than the card runs clusters at once
    (here from a launch_plan that ignores the count) is refused by every
    kernel's entry point (K1/K2, K3, K5 'fuse' and 'opt', K4), not run in
    waves, and nothing retries it under plan T; the bf16 instances
    alike."""
    real = sample_cuda.max_clusters(card)
    batch = 8 * real + 1
    voc, _, state, cond = _setup(card, batch, warm=False)
    before = dict(sample_cuda.plan_launches)
    tiles = -(-batch // sample_cuda.TILE)
    monkeypatch.setattr(sample_cuda, "launch_plan", lambda b, n: (
        "L", sample_cuda.CLUSTER_L, sample_cuda.TILE,
        tiles * sample_cuda.CLUSTER_L))
    target = torch.zeros((batch, 80), device=card)
    frame = (voc.tables, state, cond["cond_a"], cond["cond_b"], cond["lpc"],
             voc.cfg)
    for call in (lambda: sample_cuda.synth_samples(voc.tables, state, cond,
                                                   voc.cfg, 80),
                 lambda: sample_cuda.synthesize_frame(*frame),
                 lambda: sample_cuda.synthesize_frame(*frame, variant="fuse"),
                 lambda: sample_cuda.synthesize_frame(*frame, variant="opt"),
                 lambda: sample_cuda.synthesize_frame(
                     sample_scan.bf16_tables(voc.tables), *frame[1:]),
                 lambda: sample_cuda.synthesize_frame(
                     sample_scan.bf16_tables(voc.tables), *frame[1:],
                     variant="fuse"),
                 lambda: sample_cuda.teacher_advance(voc.tables, state, cond,
                                                     voc.cfg, target)):
        with pytest.raises(RuntimeError, match="launch failed"):
            call()
    assert sample_cuda.plan_launches == before


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    voc, _, state, cond = _setup(card, 2, warm=False)
    with pytest.raises(TypeError):
        sample_cuda.synth_samples(
            voc.tables, state, cond, voc.cfg, 80,
            n_active=torch.zeros(2, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        sample_cuda.synth_samples(
            voc.tables, state, cond, voc.cfg, 80,
            preload=torch.zeros(2, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        sample_cuda.teacher_advance(
            voc.tables, state, cond, voc.cfg,
            torch.zeros((2, 0), device=card))
    # K3 and K4 take float32 tables only; a mixed set is refused too
    tb = sample_scan.bf16_tables(voc.tables)
    with pytest.raises(TypeError, match="float32"):
        sample_cuda.synth_samples(tb, state, cond, voc.cfg, 80)
    with pytest.raises(TypeError, match="float32"):
        sample_cuda.teacher_advance(tb, state, cond, voc.cfg,
                                    torch.zeros((2, 80), device=card))
    with pytest.raises(TypeError, match="bfloat16"):
        sample_cuda.synthesize_frame(dict(voc.tables, tbl_exc=tb["tbl_exc"]),
                                     state, cond["cond_a"], cond["cond_b"],
                                     cond["lpc"], voc.cfg)


# ---------------------------------------------- DRED and DOT_PROD on the card

DRED_GATE_SYMBOLS, DRED_GATE_STATES = 0.995, 0.99


@pytest.mark.cuda
def test_dred_on_card_matches_cpu(card):
    """DREDCodec with the shipped weights, 3 streams x 40 frames of the
    reference features: latents within 1e-4 of the CPU's, symbols of every
    payload >= 99.5% equal and within 1, PVQ states equal on >= 99% of the
    dframes, and the features decoded from the same symbols and state
    within 1e-3."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.dred import DREDCodec, DREDConfig
    params, cfg = convert.load_dred(None, device="cpu")
    feats = np.stack([FEATS[o:o + 40, :20] for o in (0, 50, 100)])
    cfg8 = DREDConfig(num_dframes=8)
    dc_k = DREDCodec(params, cfg, cfg8, device=card)
    dc_c = DREDCodec(params, cfg, cfg8, device="cpu")
    zk, sk = dc_k.encode(feats)
    zc, sc = dc_c.encode(feats)
    assert float((zk.cpu() - zc).abs().max()) <= 1e-4
    same_state = (sk.cpu() == sc).all(-1).float().mean()
    assert float(same_state) >= DRED_GATE_STATES
    syms_k, syms_c = [], []
    for s in range(8, zc.shape[1] + 1):
        sym_k, qid = dc_k.quantize_payload(zk[:, :s])
        sym_c, _ = dc_c.quantize_payload(zc[:, :s])
        syms_k.append(sym_k.cpu())
        syms_c.append(sym_c)
        dec_k = dc_k.decode(sym_c.to(card), qid, sc[:, s - 8].to(card))
        dec_c = dc_c.decode(sym_c, qid.cpu(), sc[:, s - 8])
        assert float((dec_k.cpu() - dec_c).abs().max()) <= 1e-3
    sk_all, sc_all = torch.stack(syms_k), torch.stack(syms_c)
    assert int((sk_all - sc_all).abs().max()) <= 1
    assert float((sk_all == sc_all).float().mean()) >= DRED_GATE_SYMBOLS


@pytest.mark.cuda
@pytest.mark.parametrize("su", [False, True])
def test_dotprod_on_card_equals_cpu(card, su):
    """The DOT_PROD emulation on the card, on the CPU's tables and frame
    conditions moved there: pcm, exc, rng and GRU states exact against the
    CPU run (B=2 x 1 frame)."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.kernels import sample_dotprod
    voc = Synthesizer(device="cpu", backend="dotprod", dotprod_su=su)
    conds = {k: v for k, v in voc.conditions(
        np.stack([FEATS[10:11], FEATS[40:41]])).items()
        if k in ("cond_a", "cond_b", "lpc")}
    st0 = voc.reset(2, per_stream_rng=True)
    st_c, pcm_c = sample_dotprod.synthesize_frames_dotprod(
        voc.tables, voc.qtables, st0, conds, voc.cfg)
    tables = convert.to_device(voc.tables, card)
    q = sample_dotprod.quantize_tables(tables, voc.cfg, su_bias=su)
    st_k, pcm_k = sample_dotprod.synthesize_frames_dotprod(
        tables, q, {k: v.to(card) for k, v in st0.items()},
        {k: v.to(card) for k, v in conds.items()}, voc.cfg)
    assert torch.equal(pcm_k.cpu(), pcm_c)
    for k in ("last_exc", "rng", "gru_a", "gru_b", "deemph"):
        assert torch.equal(st_k[k].cpu(), st_c[k]), k


@pytest.mark.cuda
def test_tf32_is_refused_on_the_card(card, monkeypatch):
    """With TF32 allowed in float32 matmuls the RDO-VAE, the DOT_PROD
    group dots and the codec's VQ distances raise instead of running."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.codec import vq
    from lpcnet_tpu_torch.kernels import sample_dotprod
    from lpcnet_tpu_torch.models import rdovae
    params, cfg = convert.load_dred(None, device=card)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        rdovae.encode(params, torch.zeros((1, 8, 20), device=card), cfg)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        rdovae.decode(params, torch.zeros((1, 2, 80), device=card),
                      torch.zeros((1, 24), device=card), cfg)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        sample_dotprod._qdot(torch.zeros(12, device=card),
                             torch.zeros((2, 4, 12), device=card),
                             torch.zeros((1, 8), device=card), False)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        vq.vq_nearest(torch.zeros((4, 18), device=card),
                      torch.zeros((1, 18), device=card))


@pytest.mark.cuda
def test_dred_stream_step_at_published_widths_matches_plain(card,
                                                            monkeypatch):
    """DREDCodec.step at RDOVAEConfig() (GRUs of 1024) on weights the
    plain reference draws (every bias nonzero, a scale and dead zone of
    its own for every latent and level), 1024 streams x 40 dframes, one a call (the first call of
    each of its two graphs eager, the second captured, the rest
    replayed): bit-identical to the same
    calls run eagerly, its spans read, and against the plain reference's
    whole-history encode of 2 of the streams: latents within 1e-4 of it
    over the larger of 1 and its largest (float32 sums in other orders,
    through three GRUs: ~1e-6 measured, TF32 ~5e-4), PVQ states and
    payload symbols with the DRED gates above (a rounding tie may move a
    pulse or a symbol by one). With TF32 allowed a new state's first
    step raises."""
    from lpcnet_tpu_torch.dred import DREDCodec
    from lpcnet_tpu_torch.models import rdovae
    from lpcnet_tpu_torch.plain import rdovae_encode as plain
    from lpcnet_tpu_torch.utils import graphs, profiling
    cfg = rdovae.RDOVAEConfig()
    params = plain.draw_params(19, dataclasses.asdict(cfg))
    dc = DREDCodec(params, cfg, device=card)
    B, N, rows = 1024, 40, [3, 700]
    idx = (7 * np.arange(B)[:, None] + np.arange(4 * N)) % len(FEATS)
    feats = torch.as_tensor(FEATS[idx, :20], device=card)

    def run():
        st = dc.init_state(B)
        outs = [dc.step(st, feats[:, 4 * d:4 * d + 4]) for d in range(N)]
        return st, {k: torch.cat([o[k] for o in outs], dim=1)
                    for k in outs[0]}
    with graphs.disabled():
        _, eager = run()
    graphs.captures.clear()
    graphs.replays.clear()
    profiling.span_calls.clear()
    monkeypatch.setattr(profiling, "SPAN_READ_EVERY", 1)
    st, graphed = run()
    torch.cuda.synchronize()
    names = ("DREDCodec.step", "DREDCodec.step.recurrent")
    assert graphs.captures == {name: 1 for name in names}
    assert graphs.replays == {name: N - 1 for name in names}
    for k in eager:
        assert torch.equal(eager[k], graphed[k]), k
    dc.step(st, feats[:, :4])        # reads the spans of the last replay
    assert all(profiling.span_calls[name] >= 1 for name in names)
    assert profiling.span_ms_per_call("dred_stack") > 0
    got = {k: v[rows] for k, v in graphed.items()}
    z, s = plain.encode(dc.params, feats[rows])
    sym, oldest = plain.payloads(dc.params, z, s, range(N))
    assert float((got["latents"] - z).abs().max()) \
        <= 1e-4 * max(1.0, float(z.abs().max()))
    for mine, ref in ((got["states"], s), (got["oldest_state"], oldest)):
        same = ((mine - ref).abs().amax(-1) <= 1e-4).float().mean()
        assert float(same) >= DRED_GATE_STATES
    assert int((got["symbols"] - sym).abs().max()) <= 1
    assert float((got["symbols"] == sym).float().mean()) >= DRED_GATE_SYMBOLS
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        dc.step(dc.init_state(2), feats[:2, :4])


def _training_case(name):
    """(loss function of the parameters on a device, CPU parameters) of
    one trainer at a narrow width, on seeded inputs, noise passed in."""
    from lpcnet_tpu_torch.models import lpcnet, plc, rdovae
    from lpcnet_tpu_torch.training import lpcnet_task, plc_task, rdovae_task
    rs = np.random.RandomState(0)
    gen = torch.Generator().manual_seed(0)
    if name == "lpcnet":
        cfg = lpcnet.LPCNetConfig(gru_a_units=64, cond_size=32,
                                  embed_sig_size=16, embed_pitch_size=8)
        batch = {"sig_in": rs.randn(2, 480).astype(np.float32) * 1000,
                 "sig_out": rs.randn(2, 480).astype(np.float32) * 1000,
                 "features": FEATS[None, :7, :20].repeat(2, 0),
                 "periods": rs.randint(33, 255, (2, 7)).astype(np.int32),
                 "lpc": FEATS[None, 2:5, 20:36].repeat(2, 0)}
        return (lambda p, d: lpcnet_task.loss_fn(
            p, {k: torch.as_tensor(v, device=d) for k, v in batch.items()},
            cfg), lpcnet.init_params(gen, cfg))
    if name == "plc":
        feats = rs.randn(2, 12, 56).astype(np.float32)
        draw = rs.uniform(size=(2, 12, 1)).astype(np.float32)
        lost = (rs.uniform(size=(2, 12)) > 0.3).astype(np.int64)
        return (lambda p, d: plc_task.loss_fn(p, plc_task.make_batch(
            torch.as_tensor(draw, device=d), torch.as_tensor(feats, device=d),
            torch.as_tensor(lost, device=d))),
            plc.init_params(gen))
    cfg = rdovae.RDOVAEConfig(cond_size=32, cond_size2=32)
    feats = FEATS[:32, :20].reshape(2, 16, 20)
    noise = rs.uniform(-0.5, 0.5, (2, 8, 80)).astype(np.float32)
    q = torch.as_tensor([[3], [11]])
    return (lambda p, d: rdovae_task.loss_fn(
        p, torch.as_tensor(feats, device=d),
        *rdovae_task.sample_lambda(q.to(d), 2, 8),
        torch.as_tensor(noise, device=d), cfg),
        rdovae.rate_aware_quant_init(rdovae.init_params(gen, cfg), cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lpcnet", "plc", "rdovae"])
def test_training_loss_and_grads_on_card_match_cpu(card, name):
    """Each trainer's loss and gradients on the card against the CPU on
    the same parameters and draws (narrow widths): loss relative 1e-5,
    every gradient leaf within 1e-4 of its largest entry."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.training import optim
    loss_fn, params = _training_case(name)
    out = {}
    for d in (card, torch.device("cpu")):
        (loss, _), g = optim.value_and_grad(
            lambda p: loss_fn(p, d), convert.to_device(params, d))
        out[d.type] = (float(loss), [x.cpu() for x in optim.tree_leaves(g)])
    assert abs(out["cuda"][0] / out["cpu"][0] - 1) <= 1e-5
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_training_refuses_tf32_on_the_card(card, monkeypatch):
    """With TF32 allowed, the training losses and the codebook trainer
    raise instead of running their products in TF32."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.codec import vq_train
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    for name in ("lpcnet", "plc", "rdovae"):
        loss_fn, params = _training_case(name)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            loss_fn(convert.to_device(params, card), card)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        vq_train.kmeans(torch.Generator(device=card),
                        torch.zeros((8, 17), device=card), 2, 1, 0)


DP_WORKER = """
import numpy as np
import torch
from lpcnet_tpu_torch.parallel import mesh
from lpcnet_tpu_torch.vocoder import Synthesizer


def synth(rank, world, device, feats_path):
    feats = np.load(feats_path)
    voc = Synthesizer(device=device)
    state, synth_fn = mesh.shard_synthesis(voc, len(feats), gather=True)
    _, pcm = synth_fn(state, feats)
    return {"pcm": None if pcm is None else pcm.cpu()}
"""


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_shard_synthesis_on_the_card_equals_one_synthesizer(card, backend,
                                                            tmp_path):
    """Stream-parallel synthesis of 64 streams x 2 frames, gathered onto
    rank 0, bit for bit one Synthesizer on the whole batch with per-stream
    seeds: an NCCL world over every visible card, and two gloo ranks on
    cuda:0 (32 streams each, plan L)."""
    from lpcnet_tpu_torch.parallel import mesh
    B = 64
    offs = (5 * np.arange(B)) % (len(FEATS) - 2)
    feats = np.stack([FEATS[o:o + 2] for o in offs])
    np.save(tmp_path / "f.npy", feats)
    (tmp_path / "dp_card_worker.py").write_text(DP_WORKER)
    n = torch.cuda.device_count()
    devices = ([f"cuda:{r}" for r in range(n)] if backend == "nccl"
               else ["cuda:0", "cuda:0"])
    out = mesh.spawn("dp_card_worker:synth", len(devices), devices, backend,
                     [str(tmp_path / "f.npy")], timeout=300,
                     pythonpath=[str(tmp_path)])
    voc = Synthesizer(device=card)
    _, pcm = voc.synthesize(voc.reset(B, per_stream_rng=True), feats)
    assert torch.equal(out[0]["pcm"], pcm.cpu())
    assert all(o["pcm"] is None for o in out[1:])


@pytest.mark.cuda
def test_bench_headline_runs_the_frame_kernel_under_its_plan(card,
                                                            monkeypatch):
    """The bench's headline at B=8 x 2 frames, one timed call after the
    warm-up, through the graphed synthesize: the warm-up's first call runs
    eagerly and its second captures (two launches of the flat frame kernel
    (K1) in each, every one under plan L), the capturing call and the
    timed one replay it, and a trace of the timed call has sample-kernel
    time in it."""
    from lpcnet_tpu_torch import bench
    from lpcnet_tpu_torch.utils import graphs
    monkeypatch.setenv("LPCNET_BENCH_BATCH", "8")
    monkeypatch.setenv("LPCNET_BENCH_FRAMES", "2")
    monkeypatch.setenv("LPCNET_BENCH_ITERS", "1")
    for counts in (sample_cuda.launches, sample_cuda.plan_launches):
        for k in counts:
            counts[k] = 0
    graphs.captures.clear()
    graphs.replays.clear()
    result, rt, util = bench.bench_synthesis(card)
    n = 2 * graphs.CAPTURE_CALL
    assert sample_cuda.launches["flat"] == n
    assert sum(sample_cuda.launches.values()) == n
    assert sample_cuda.plan_launches == {"L": n, "T": 0}
    assert graphs.captures == {"Synthesizer.synthesize": 1}
    assert graphs.replays == {"Synthesizer.synthesize": 2}
    assert result["metric"] == "synthesis_rt_factor_per_chip" and rt > 0
    assert util is not None and 0 < util["duty_cycle"] <= 1
    assert 0 < util["device_occupancy"] <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32], ids=["B1", "B32"])
def test_graft_entry_captured_step(card, batch):
    """The graft entry's step (conditioning, then K1 under plan L) captured
    as one CUDA graph: its replay is bit-identical to the eager call, and
    the eager call to the plain loop on the same conditions, on the
    example args and on a second state and frame of features; the
    replays read their arguments. compile_step refuses CPU arguments."""
    from lpcnet_tpu_torch import graft_entry
    fn, args = graft_entry.entry(device=card, batch=batch)
    voc = Synthesizer(device=card)
    eager = fn(*args)
    assert sample_cuda.last_plan[0] == "L"
    offs = np.random.RandomState(batch).randint(0, len(FEATS), batch)
    sets = [(args, eager)]
    args2 = (eager[0], torch.as_tensor(FEATS[offs][:, None], device=card))
    sets.append((args2, fn(*args2)))
    step = graft_entry.compile_step(fn, args)
    for (st, f), (st_e, pcm_e) in sets:
        conds = voc.conditions(f)
        st_p, pcm_p = sample_scan.synthesize_frames(
            voc.tables, st, {k: conds[k].contiguous()
                             for k in ("cond_a", "cond_b", "lpc")},
            voc.cfg, flat=True)
        st_r, pcm_r = step(st, f)
        assert torch.equal(pcm_e, pcm_p) and torch.equal(pcm_r, pcm_e)
        for k, v in st_e.items():
            assert torch.equal(v, st_p[k]) and torch.equal(st_r[k], v), k
    assert step.replays == 2
    assert not torch.equal(sets[0][1][1], sets[1][1][1])
    cpu_args = ({k: v.cpu() for k, v in args[0].items()}, args[1].cpu())
    with pytest.raises(RuntimeError, match="CUDA graph"):
        graft_entry.compile_step(fn, cpu_args)


@pytest.mark.cuda
def test_graft_capture_fails_on_a_per_call_upload(card, monkeypatch):
    """What ops/tables.device_constant repairs: with the conditioning's
    numpy constants uploaded in every call again (a pageable copy, which
    waits on the stream), the step cannot be captured, and compile_step
    raises rather than call fn eagerly. The card captures the step again
    once the constants stay on it."""
    from lpcnet_tpu_torch import graft_entry
    from lpcnet_tpu_torch.ops import dsp
    fn, args = graft_entry.entry(device=card, batch=1)
    monkeypatch.setattr(dsp, "device_constant",
                        lambda a, device: torch.as_tensor(a, device=device))
    with pytest.raises(RuntimeError, match="could not be captured"):
        graft_entry.compile_step(fn, args)
    monkeypatch.undo()
    step = graft_entry.compile_step(fn, args)
    assert torch.equal(step(*args)[1], fn(*args)[1])


# ---- the entry points as CUDA graphs (utils/graphs.py): (entry point,
# variant) of each graphed case; every one at B=1 (plan L) and B=1024
# (plan T), a chain of GRAPH_CALLS calls that carries the state
GRAPH_CASES = ["synthesize-flat", "synthesize-base", "synthesize-fuse",
               "synthesize-opt", "synthesize-flat_bf16",
               "synthesize-opt_bf16", "synthesize_teacher",
               "synthesize_streaming", "PLCEngine", "NonCausalPLCEngine",
               "StrictCausalPLCEngine", "dred_encode", "dred_decode"]
GRAPH_CALLS, GRAPH_FRAMES = 3, 2


def _graph_case(card, case, batch, calls=GRAPH_CALLS):
    """(the jit, the public method, the initial state or None, the
    arguments of each call after the state) of a graphed entry point at
    `batch` streams on the shipped weights."""
    from lpcnet_tpu_torch import convert, plc
    from lpcnet_tpu_torch.dred import DREDCodec
    T = GRAPH_FRAMES
    n = max(calls * T, 64)                 # DRED takes 64 frames a call
    offs = (5 * np.arange(batch)) % (len(FEATS) - n)
    feats = np.stack([FEATS[o:o + n] for o in offs])
    per_call = [(feats[:, i * T:(i + 1) * T],) for i in range(calls)]
    rs = np.random.RandomState(batch)
    if case.startswith("synthesize-"):
        variant, _, tables = case.split("-")[1].partition("_")
        voc = Synthesizer(device=card, variant=variant,
                          tables=tables or "f32")
        return (voc._synth, voc.synthesize,
                voc.reset(batch, per_stream_rng=True), per_call)
    if case == "synthesize_teacher":
        voc = Synthesizer(device=card)
        args = [(f, (rs.randn(batch, T * 160) * 3000).astype(np.float32),
                 rs.randint(0, 161, (batch, T))) for (f,) in per_call]
        return (voc._synth_teacher, voc.synthesize_teacher,
                voc.reset(batch, per_stream_rng=True), args)
    if case == "synthesize_streaming":
        voc = Synthesizer(device=card)
        return (voc._synth_streaming, voc.synthesize_streaming,
                voc.reset_streaming(batch, True), per_call)
    if case.startswith("dred"):
        params, cfg = convert.load_dred(None, device=card)
        dc = DREDCodec(params, cfg, device=card)
        feats64 = [torch.as_tensor(feats[:, :, :20], device=card)
                   + 0.01 * i for i in range(calls)]
        if case == "dred_encode":
            return dc._encode, dc.encode, None, [(f,) for f in feats64]
        args = []
        for f in feats64:
            zd, sd = dc._encode_impl(f)
            args.append((*dc.quantize_payload(zd), sd[:, 0]))
        return dc._decode, dc.decode, None, args
    eng = getattr(plc, case)(convert.load_lpcnet(device=card),
                             convert.load_plc(device=card), device=card)
    pcm = (rs.randn(batch, calls * 160) * 3000).astype(np.float32)
    lost = rs.uniform(size=(batch, calls)) < 0.3
    lost[0, :3] = [False, True, False][:calls]  # stream 0: a loss, a blend
    return (eng._step, eng.step, eng.init_state(batch),
            [(pcm[:, t * 160:(t + 1) * 160], lost[:, t])
             for t in range(calls)])


def _chain(method, state, args):
    """The calls in order, each on the state the last one left (None: a
    stateless entry point)."""
    outs = []
    for a in args:
        outs.append(method(*a) if state is None else method(state, *a))
        state = None if state is None else outs[-1][0]
    return outs


def _tree_equal(a, b) -> bool:
    from lpcnet_tpu_torch.utils import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1024], ids=["B1", "B1024"])
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_graphed_entry_point_bit_identical_to_eager(card, case, batch):
    """Each entry point's chain of calls, graphed, is bit-identical to the
    same chain under graphs.disabled(), its outputs and every state leaf:
    K1/K2/K5 (f32 and bf16), K3 and K4 inside captures, under plan L at
    B=1 and plan T at B=1024. The first call runs eagerly, the second
    captures; it and every later call replay, and no replay launches a
    kernel from the host."""
    from lpcnet_tpu_torch.utils import graphs
    step, method, state, args = _graph_case(card, case, batch)
    graphs.captures.clear()
    graphs.replays.clear()
    with graphs.disabled():
        eager = _chain(method, state, args)
    assert not graphs.captures and not graphs.replays
    k = graphs.CAPTURE_CALL
    graphed = _chain(method, state, args[:k])
    if not case.startswith("dred"):          # DRED launches no sample kernel
        assert sample_cuda.last_plan[0] == ("L" if batch == 1 else "T")
    before = dict(sample_cuda.launches)
    graphed += _chain(method, None if state is None else graphed[-1][0],
                      args[k:])
    assert sample_cuda.launches == before
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: len(args) - k + 1}
    for e, g in zip(eager, graphed):
        assert _tree_equal(e, g), case


@pytest.mark.cuda
def test_graph_cache_replays_a_shape_and_captures_a_new_one(card):
    """The first call of a signature runs eagerly, the second captures it
    and replays, the third replays the same graph; a new batch or frame
    count runs eagerly once and then captures a second graph; inside
    graphs.disabled() nothing is captured or replayed; the kernel
    wrappers' launch counters tick in the eager call and the capture
    only. Dropping the synthesizer frees its graphs with it."""
    import gc
    import weakref
    from lpcnet_tpu_torch.utils import graphs
    name = "Synthesizer.synthesize"
    graphs.captures.clear()
    graphs.replays.clear()
    voc = Synthesizer(device=card)
    f = FEATS[None, :2]
    before = sample_cuda.launches["flat"]
    voc.synthesize(voc.reset(1), f)
    assert sample_cuda.launches["flat"] == before + 2
    assert not graphs.captures and not voc._synth.steps
    voc.synthesize(voc.reset(1), FEATS[None, 5:7])
    assert sample_cuda.launches["flat"] == before + 4
    assert graphs.captures[name] == 1 and graphs.replays[name] == 1
    before = sample_cuda.launches["flat"]
    voc.synthesize(voc.reset(1), FEATS[None, 7:9])
    assert sample_cuda.launches["flat"] == before
    assert graphs.captures[name] == 1 and graphs.replays[name] == 2
    for _ in range(2):
        voc.synthesize(voc.reset(2), np.concatenate([f, f]))
        voc.synthesize(voc.reset(1), FEATS[None, :3])
    assert graphs.captures[name] == 3 and len(voc._synth.steps) == 3
    with graphs.disabled():
        voc.synthesize(voc.reset(1), f)
    assert graphs.captures[name] == 3 and graphs.replays[name] == 4
    graph = weakref.ref(next(iter(voc._synth.steps.values())).graph)
    gc.disable()
    try:
        del voc
        assert graph() is None
    finally:
        gc.enable()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1024], ids=["B1", "B1024"])
def test_plc_run_equals_its_steps(card, batch):
    """PLCEngine.run replays the step's graph once per frame: the same
    state and output as T step calls, graphed or eager."""
    from lpcnet_tpu_torch.utils import graphs
    step, method, state, args = _graph_case(card, "PLCEngine", batch, 4)
    eng = method.__self__
    pcm = np.concatenate([a[0] for a in args], axis=1)
    lost = np.stack([a[1] for a in args], axis=1)
    graphs.captures.clear()
    graphs.replays.clear()
    st_r, out_r = eng.run(state, pcm, lost)
    # the first step eager, the second captured, it and the others replays
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: 3}
    outs = _chain(method, state, args)
    with graphs.disabled():
        st_e, out_e = eng.run(state, pcm, lost)
    assert graphs.replays == {step.name: 7}
    assert torch.equal(out_r, torch.cat([o[1] for o in outs], 1))
    assert torch.equal(out_r, out_e)
    assert _tree_equal(st_r, outs[-1][0]) and _tree_equal(st_r, st_e)


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["plc", "ops.burg", "features"])
def test_graphed_step_fails_on_a_per_call_upload(card, monkeypatch, module):
    """What the device constants repair: with one module's numpy constants
    uploaded in every call again (a pageable copy, which waits on the
    stream), PLCEngine.step runs eagerly on its first call but cannot be
    captured on its second, and it raises naming itself rather than run
    eagerly. The step captures once the constants stay on the card (made
    by an eager call)."""
    import importlib
    from lpcnet_tpu_torch.utils import graphs
    mod = importlib.import_module("lpcnet_tpu_torch." + module)
    step, method, state, args = _graph_case(card, "PLCEngine", 1, 1)
    graphs.captures.clear()
    monkeypatch.setattr(mod, "device_constant",
                        lambda a, device: torch.as_tensor(a, device=device))
    method(state, *args[0])
    with pytest.raises(RuntimeError, match="PLCEngine.step: the call could "
                                           "not be captured"):
        method(state, *args[0])
    assert not graphs.captures and step.steps == {}
    monkeypatch.undo()
    with graphs.disabled():
        method(state, *args[0])
    method(state, *args[0])
    assert graphs.captures == {step.name: 1}


# Burg's cepstral analysis: the kernel (csrc/burg_cepstrum.cu) against
# the plain PyTorch version on the same card. 1e-4 absolute: float32 sums
# in another order (index order in the kernel, PyTorch's reductions,
# cuFFT and cuBLAS in the plain version) carried through the 16 dependent
# steps of the recursion and 1 / |A|^2 at the spectrum's dips. 2e-3 on
# full-scale clipped tones, where the gain guard hits just past its
# threshold and sqrt(1 - 1e-3 / inv_gain) magnifies any rounding: there
# the plain version itself lies up to 9.4e-4 from its result on the CPU
# and up to 7.1e-4 from a float64 copy of it.
BURG_TOL, BURG_TOL_CLIPPED = 1e-4, 2e-3
BURG_SHAPES = [(160,), (1, 160), (2, 3, 160), (1024, 160)]
BURG_KINDS = ("golden", "speech", "zeros", "clipped", "sine")
_HERE = os.path.dirname(__file__)


def _burg_frames():
    """{kind: (n, 160) float32}: the golden frames, frames of the
    benchmark's speech, all-zero frames (a lost frame's pcm), full-scale
    clipped tones and pure tones (every half-frame predictable past the
    gain guard)."""
    golden = np.fromfile(os.path.join(_HERE, "golden", "burg.bin"),
                         np.float32).reshape(-1, 196)
    speech = np.fromfile(os.path.join(_HERE, os.pardir, "lpcbench", "data",
                                      "speech.s16"), np.int16)
    t = np.arange(160)[None]
    f = np.array([220.0, 440.0, 1000.0, 3100.0])[:, None]
    tone = np.sin(2 * np.pi * f * t / 16000 + f / 100)
    return {"golden": golden[:, :160],
            "speech": speech.reshape(-1, 160)[::5].astype(np.float32),
            "zeros": np.zeros((4, 160), np.float32),
            "clipped": np.clip(4e4 * tone, -32767, 32767).astype(np.float32),
            "sine": (8000 * tone).astype(np.float32)}


def _burg_batch(shape):
    """Frames of every kind in turn, as many as `shape` holds, and the kind
    of each (flat)."""
    frames = _burg_frames()
    n = int(np.prod(shape[:-1]))
    order = [(k, frames[k][i % len(frames[k])])
             for i in range(n) for k in BURG_KINDS][:n]
    return (np.stack([f for _, f in order]).reshape(shape),
            np.array([k for k, _ in order]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BURG_SHAPES,
                         ids=["x".join(map(str, s)) for s in BURG_SHAPES])
def test_burg_kernel_matches_plain(card, shape):
    """ops/burg.burg_cepstral_analysis on a CUDA tensor is one launch of
    the kernel, with the plain version's result to BURG_TOL
    (BURG_TOL_CLIPPED on clipped tones)."""
    from lpcnet_tpu_torch.kernels import burg_cuda
    from lpcnet_tpu_torch.ops import burg
    frames, kinds = _burg_batch(shape)
    x = torch.as_tensor(frames, device=card)
    before = burg_cuda.launches
    got = burg.burg_cepstral_analysis(x)
    assert burg_cuda.launches == before + 1
    want = burg.burg_cepstral_analysis_plain(x)
    assert got.shape == shape[:-1] + (36,)
    gap = (got - want).abs().reshape(-1, 36).max(-1).values.cpu().numpy()
    tol = np.where(kinds == "clipped", BURG_TOL_CLIPPED, BURG_TOL)
    assert (gap <= tol).all(), {k: float(gap[kinds == k].max())
                                for k in set(kinds)}


@pytest.mark.cuda
def test_burg_kernel_golden(card):
    """Against the reference C's burg_cepstral_analysis, with the
    tolerances of tests/test_burg.py."""
    from lpcnet_tpu_torch.ops import burg
    d = np.fromfile(os.path.join(_HERE, "golden", "burg.bin"),
                    np.float32).reshape(-1, 196)
    got = burg.burg_cepstral_analysis(torch.as_tensor(d[:, :160],
                                                      device=card))
    np.testing.assert_allclose(got.cpu().numpy(), d[:, 160:], rtol=2e-3,
                               atol=5e-3)


@pytest.mark.cuda
def test_burg_kernel_gain_guard_agrees_with_plain(card):
    """The kernel's gain-guard decision per half-frame equals the plain
    version's on every test frame: there the guard hit where its
    coefficients differ from the same analysis without a guard. Every
    pure tone hits and no zero frame does."""
    from lpcnet_tpu_torch.kernels import burg_cuda
    from lpcnet_tpu_torch.ops import burg
    frames = _burg_frames()
    x = torch.as_tensor(np.concatenate([frames[k] for k in BURG_KINDS]),
                        device=card)
    hit = torch.full((x.shape[0], 2), -1, dtype=torch.int32, device=card)
    burg_cuda.burg_cepstral_analysis(x, burg.kernel_tables(card), hit=hit)
    halves = torch.stack([x[:, :80], x[:, 80:]], dim=1)
    pre = halves[..., 1:] - 0.85 * halves[..., :-1]
    guarded, _ = burg.burg_analysis(pre, 1e-3)
    free, _ = burg.burg_analysis(pre, 0.0)
    plain = (guarded != free).any(-1)
    assert torch.equal(hit.bool(), plain) and bool((hit >= 0).all())
    kinds = np.concatenate([[k] * len(frames[k]) for k in BURG_KINDS])
    hit = hit.cpu().numpy()
    assert hit[kinds == "sine"].all() and not hit[kinds == "zeros"].any()


@pytest.mark.cuda
def test_captured_plc_step_replays_the_burg_kernel(card):
    """PLCEngine.step graphed: the eager first call and the capture each
    launch the Burg kernel once, a replay launches nothing from the host,
    and the chain is bit-identical to the same calls eagerly."""
    from lpcnet_tpu_torch.kernels import burg_cuda
    from lpcnet_tpu_torch.utils import graphs
    step, method, state, args = _graph_case(card, "PLCEngine", 1, 3)
    before = burg_cuda.launches
    with graphs.disabled():
        eager = _chain(method, state, args)
    assert burg_cuda.launches == before + 3
    graphs.captures.clear()
    graphs.replays.clear()
    graphed = _chain(method, state, args)
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: 2}
    assert burg_cuda.launches == before + 5
    for e, g in zip(eager, graphed):
        assert _tree_equal(e, g)


@pytest.mark.cuda
def test_synthesis_never_loads_the_burg_library(card):
    """A process that synthesizes on the card (the synthesis cells' path)
    neither builds nor loads the Burg kernel's library: it is loaded at the
    first Burg call on a CUDA tensor, apart from the sample kernels'."""
    import subprocess
    import sys
    code = ("import numpy as np, torch\n"
            "from lpcnet_tpu_torch.vocoder import Synthesizer\n"
            "voc = Synthesizer(device=torch.device('cuda'))\n"
            "f = np.fromfile('tests/golden/ref_feats.f32', np.float32)\n"
            "voc.synthesize(voc.reset(1), f.reshape(-1, 36)[None, :4])\n"
            "torch.cuda.synchronize()\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('sample', 'libsample_frame' in maps)\n"
            "print('burg', 'libburg_cepstrum' in maps)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.join(_HERE, os.pardir),
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:] == ["sample True", "burg False", ""]


# LPC from the cepstrum: on the card the band spectrum and its inverse FFT
# are the plain version's PyTorch operations and the rest one kernel
# (csrc/lpc_levinson.cu), held bit for bit against the plain version on the
# same card: the sample loop quantizes the LPC prediction, and the
# benchmark's reference recomputes the conditioning in plain PyTorch.
LPC_SHAPES = [(1,), (2,), (1, 1), (3, 5, 7), (1024, 50)]
LPC_KINDS = ("golden", "speech", "zeros", "peaky")


def _lpc_rows():
    """{kind: (n, 18) float32}: the golden features, features of the
    benchmark's speech (the feature pass on the CPU), all-zero cepstra and
    peaky spectra (one band 10^5-10^8 above the rest, most of which
    Levinson predicts past 30 dB and stops early)."""
    from lpcnet_tpu_torch import features
    from lpcnet_tpu_torch.ops import dsp
    data = os.path.join(_HERE, os.pardir, "lpcbench", "data")
    golden = np.fromfile(os.path.join(data, "ref_feats.f32"),
                         np.float32).reshape(-1, 36)
    x = np.fromfile(os.path.join(data, "speech.s16"), np.int16)[:200 * 160]
    _, speech, _ = features.compute_features(
        features.init_state(1), torch.as_tensor(x.astype(np.float32)[None]))
    log_e = []
    for peak in (5.0, 6.0, 7.0, 8.0):
        for k in range(0, 18, 2):
            for wide in (False, True):
                e = np.zeros(18, np.float32)
                e[k] = peak
                if wide:
                    e[max(k - 1, 0)] = e[min(k + 1, 17)] = peak / 2
                log_e.append(e)
    peaky = dsp.dct(torch.as_tensor(np.stack(log_e))).numpy()
    peaky[:, 0] -= 4.0
    return {"golden": golden[:, :18], "speech": speech[0, :, :18].numpy(),
            "zeros": np.zeros((4, 18), np.float32), "peaky": peaky}


def _lpc_batch(shape):
    """Rows of every kind in turn, as many as `shape` holds, each followed
    by 18 other floats (the features' other columns), and the kind of each
    (flat)."""
    rows = _lpc_rows()
    n = int(np.prod(shape))
    order = [(k, rows[k][i % len(rows[k])])
             for i in range(n) for k in LPC_KINDS][:n]
    tail = np.random.RandomState(0).randn(n, 18).astype(np.float32)
    wide = np.concatenate([np.stack([r for _, r in order]), tail], axis=1)
    return wide.reshape(shape + (36,)), np.array([k for k, _ in order])


def _lpc_plain_steps(cep: torch.Tensor) -> torch.Tensor:
    """The Levinson steps each row of lpc_from_cepstrum_plain ran (its
    reflection coefficients are 0 from the step where it stopped)."""
    from lpcnet_tpu_torch.ops import dsp
    x = dsp.interp_band_gain(dsp._band_energies(cep))
    ac = dsp.inverse_transform(x.to(torch.complex64))[..., :17]
    ac0 = ac[..., 0] + ac[..., 0] * 1e-4 + float(np.float32(26.0 / 38.0))
    lag = torch.as_tensor(dsp._LAG, device=cep.device)
    _, rc, _ = dsp.levinson(torch.cat([ac0[..., None], ac[..., 1:] * lag],
                                      dim=-1))
    return (rc != 0).sum(-1).to(torch.int32)


def _lpc_steps(cep: torch.Tensor) -> torch.Tensor:
    """The Levinson steps the kernel ran on each row (its steps output)."""
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.ops import dsp
    x = dsp.interp_band_gain(dsp._band_energies(cep))
    y = torch.fft.irfft(x.to(torch.complex64), n=320, dim=-1)
    steps = torch.full(cep.shape[:-1], -1, dtype=torch.int32,
                       device=cep.device)
    lpc_cuda.lpc_from_lags(y, torch.as_tensor(dsp._LAG, device=cep.device),
                           steps=steps)
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("shape", LPC_SHAPES,
                         ids=["x".join(map(str, s)) for s in LPC_SHAPES])
def test_lpc_kernel_matches_plain(card, shape):
    """ops/dsp.lpc_from_cepstrum on a CUDA tensor launches the kernel once
    and gives the plain version's lpc and err on the same card bit for bit,
    every kind of row; the kernel's early-exit decisions are the plain
    recursion's, row for row."""
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.ops import dsp
    feats, kinds = _lpc_batch(shape)
    x = torch.as_tensor(feats, device=card)
    before = lpc_cuda.launches
    lpc, err = dsp.lpc_from_cepstrum(x)
    assert lpc_cuda.launches == before + 1
    assert lpc.shape == shape + (16,) and err.shape == shape
    want_lpc, want_err = dsp.lpc_from_cepstrum_plain(x)
    differ = ((lpc != want_lpc).any(-1) | (err != want_err)).reshape(-1)
    print(f"[lpc] {shape}: rows that differ from the plain version "
          f"{int(differ.sum())} of {differ.numel()}")
    assert not bool(differ.any()), {
        k: int(differ.cpu().numpy()[kinds == k].sum()) for k in LPC_KINDS}
    assert torch.equal(_lpc_steps(x), _lpc_plain_steps(x))


@pytest.mark.cuda
def test_lpc_kernel_takes_the_early_exit_on_peaky_rows(card):
    """Most peaky rows stop before the last step, in the kernel and in the
    plain recursion alike, and no row of the golden or speech features or
    zeros does."""
    for kind, cep in _lpc_rows().items():
        x = torch.as_tensor(cep, device=card)
        steps = _lpc_steps(x)
        assert torch.equal(steps, _lpc_plain_steps(x)), kind
        early = int((steps < 16).sum())
        if kind == "peaky":
            assert len(cep) // 2 < early < len(cep)
        else:
            assert early == 0, kind


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1,), (1024, 50)], ids=["1", "1024x50"])
def test_lpc_graphed_call_bit_identical_to_eager(card, shape):
    """lpc_from_cepstrum captured in a CUDA graph: the capture launches the
    kernel once from the host, a replay none, and each replay gives the
    eager call's bits on the inputs it finds (two sets)."""
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.ops import dsp
    feats, _ = _lpc_batch(shape)
    inputs = [torch.as_tensor(feats, device=card),
              torch.as_tensor(feats[..., ::-1].copy(), device=card)]
    eager = [dsp.lpc_from_cepstrum(x) for x in inputs]
    static = inputs[0].clone()
    g = torch.cuda.CUDAGraph()
    before = lpc_cuda.launches
    with torch.cuda.graph(g):
        out = dsp.lpc_from_cepstrum(static)
    assert lpc_cuda.launches == before + 1
    for x, want in zip(inputs, eager):
        static.copy_(x)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    assert lpc_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case,per_call", [("synthesize-flat", 1),
                                           ("PLCEngine", 2)])
def test_lpc_launches_per_entry_point_call(card, case, per_call):
    """The kernel launches once per Synthesizer.synthesize call (the
    conditioning of all its frames) and twice per PLCEngine step (the
    feature pass and the frame network), eager and in a capture; a replay
    launches nothing from the host."""
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.utils import graphs
    step, method, state, args = _graph_case(card, case, 1, 3)
    before = lpc_cuda.launches
    with graphs.disabled():
        _chain(method, state, args)
    assert lpc_cuda.launches == before + 3 * per_call
    graphs.captures.clear()
    _chain(method, state, args)
    assert graphs.captures == {step.name: 1}
    assert lpc_cuda.launches == before + 5 * per_call


@pytest.mark.cuda
def test_lpc_kernel_refuses_a_tensor_that_requires_grad(card):
    from lpcnet_tpu_torch.kernels import lpc_cuda
    from lpcnet_tpu_torch.ops import dsp
    x = torch.zeros(2, 320, device=card, requires_grad=True)
    before = lpc_cuda.launches
    with pytest.raises(ValueError, match="no backward"):
        lpc_cuda.lpc_from_lags(x, torch.as_tensor(dsp._LAG, device=card))
    assert lpc_cuda.launches == before


def _train_run(card, name):
    """(the jit, the initial params, the optimizer, a function of the
    last step's params and state giving the next step's arguments, the
    generator) of one trainer at a narrow width on the card, made anew
    from the same seeds on every call."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.models import lpcnet, plc, rdovae
    from lpcnet_tpu_torch.training import lpcnet_task, plc_task, rdovae_task
    rs = np.random.RandomState(0)
    init = torch.Generator().manual_seed(0)
    gen = torch.Generator(device=card).manual_seed(1)

    def dev(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=card)

    if name == "lpcnet":
        cfg = lpcnet.LPCNetConfig(gru_a_units=64, cond_size=32,
                                  embed_sig_size=16, embed_pitch_size=8)
        batch = {"sig_in": dev(rs.randn(2, 480) * 1000),
                 "sig_out": dev(rs.randn(2, 480) * 1000),
                 "features": dev(FEATS[None, :7, :20].repeat(2, 0)),
                 "periods": dev(rs.randint(33, 255, (2, 7)), torch.int32),
                 "lpc": dev(FEATS[None, 2:5, 20:36].repeat(2, 0))}
        opt = lpcnet_task.make_optimizer()
        return (lpcnet_task.train_step,
                convert.to_device(lpcnet.init_params(init, cfg), card), opt,
                lambda p, s: (p, s, batch, cfg, opt, gen), gen)
    if name == "plc":
        cfg = plc.PLCConfig()
        feats = dev(rs.randn(2, 12, 56))
        lost = dev(rs.uniform(size=(2, 12)) > 0.3, torch.bool)
        opt = plc_task.make_optimizer()
        return (plc_task.train_step,
                convert.to_device(plc.init_params(init, cfg), card), opt,
                lambda p, s: (p, s, plc_task.make_batch(gen, feats, lost),
                              cfg, opt), gen)
    cfg = rdovae.RDOVAEConfig(cond_size=32, cond_size2=32)
    feats = dev(FEATS[:32, :20].reshape(2, 16, 20))
    opt = rdovae_task.make_optimizer()

    def args(p, s):
        # the level drawn between steps from the step's noise generator,
        # as train-rdovae draws it
        q, lam = rdovae_task.sample_lambda(gen, 2, 8, device=card)
        return (p, s, feats, q, lam, gen, cfg, opt)

    params = rdovae.rate_aware_quant_init(rdovae.init_params(init, cfg), cfg)
    return (rdovae_task.train_step, convert.to_device(params, card), opt,
            args, gen)


def _train_steps(card, name, n, graphed):
    """n steps of a fresh run; (the trees each step returned, the
    generator's state after the last)."""
    from lpcnet_tpu_torch.utils import graphs
    step, params, opt, args, gen = _train_run(card, name)
    state, outs = opt.init(params), []
    with contextlib.nullcontext() if graphed else graphs.disabled():
        for _ in range(n):
            params, state, metrics = step(*args(params, state))
            outs.append((params, state, metrics))
    return outs, gen.get_state()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["lpcnet", "plc", "rdovae"])
def test_graphed_train_steps_bit_identical_to_eager(card, name):
    """Each trainer's train_step, 4 steps from the same parameters,
    optimizer state, batch and generator seed: graphed (the first step
    eager, the second captured, it and the others replays) against
    graphs.disabled() and two eager runs against each other. Params, Adam
    moments, counts and metrics are bit-identical at every step, and the
    generator (the LPCNet noise, the PLC dropout drawn between steps, the
    RDO-VAE noise and levels) ends in the same state."""
    from lpcnet_tpu_torch.utils import graphs
    step = _train_run(card, name)[0]
    step.clear()
    eager, gen_e = _train_steps(card, name, 4, graphed=False)
    again, gen_a = _train_steps(card, name, 4, graphed=False)
    assert all(_tree_equal(a, b) for a, b in zip(eager, again)), \
        f"{name}: two eager runs differ"
    assert torch.equal(gen_e, gen_a)
    graphs.captures.clear()
    graphs.replays.clear()
    graphed, gen_g = _train_steps(card, name, 4, graphed=True)
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: 3}
    for k, (e, g) in enumerate(zip(eager, graphed)):
        assert _tree_equal(e, g), f"{name}: step {k + 1}"
        assert g[1]["count"].dtype == torch.int32 and int(g[1]["count"]) \
            == k + 1
    assert torch.equal(gen_e, gen_g)
    step.clear()


@pytest.mark.cuda
def test_train_lpcnet_command_captures_once(card, tmp_path):
    """train-lpcnet on the card for 2 epochs of 3 steps: one capture of
    lpcnet_task.train_step and 5 replays (the first step eager, the
    second captured and replayed), and its --resume continues from the
    checkpoint."""
    from lpcnet_tpu_torch import cli
    from lpcnet_tpu_torch.training import lpcnet_task
    from lpcnet_tpu_torch.utils import checkpoint, graphs
    rs = np.random.RandomState(0)
    f = rs.randn(100, 36).astype(np.float32) * 0.3
    f[:, 20:] = 0.0
    f.tofile(tmp_path / "f.f32")
    (rs.randn(100 * 160, 2) * 500).astype(np.int16).tofile(tmp_path / "d.s16")
    out = str(tmp_path / "run")
    argv = ["train-lpcnet", str(tmp_path / "f.f32"), str(tmp_path / "d.s16"),
            out, "--batch-size", "2", "--steps-per-epoch", "3",
            "--device", str(card)]
    name = lpcnet_task.train_step.name
    lpcnet_task.train_step.clear()
    graphs.captures.clear()
    graphs.replays.clear()
    assert cli.main(argv + ["--epochs", "2"]) == 0
    assert graphs.captures[name] == 1 and graphs.replays[name] == 5
    ck = os.path.join(out, "ckpt_001.bin")
    assert checkpoint.load_training(ck)[2] == 6
    assert cli.main(argv + ["--epochs", "1", "--resume", ck]) == 0
    tree, leaves, step, meta = checkpoint.load_training(
        os.path.join(out, "ckpt_002.bin"))
    assert step == 9 and leaves[0].item() == leaves[-1].item() == 9
    lpcnet_task.train_step.clear()


@pytest.mark.cuda
def test_graphed_train_step_fails_on_a_per_call_upload(card, monkeypatch):
    """With the mu-law's log 256 uploaded in every call again (a pageable
    copy), the LPCNet train step runs eagerly on its first call but cannot
    be captured on its second, and raises naming itself rather than run
    eagerly; with the constant kept on the card it captures."""
    from lpcnet_tpu_torch.training import losses
    from lpcnet_tpu_torch.utils import graphs
    step, params, opt, args, _ = _train_run(card, "lpcnet")
    step.clear()
    graphs.captures.clear()
    state = opt.init(params)
    monkeypatch.setattr(losses, "device_constant",
                        lambda a, device: torch.as_tensor(a, device=device))
    step(*args(params, state))
    with pytest.raises(RuntimeError, match="lpcnet_task.train_step: the call "
                                           "could not be captured"):
        step(*args(params, state))
    assert not graphs.captures and step.steps == {}
    monkeypatch.undo()
    step(*args(params, state))
    assert graphs.captures == {step.name: 1}
    step.clear()


# ---- the JAX package's other jit sites (tests/test_torch_jit_sites.py on
# the CPU): the feature and codec steps (data.py), the k-means updates
# (codec/vq_train.py), the tools' steps; each a chain of JIT_SITE_CALLS
# calls at two sizes (streams, frames or corpus rows: JIT_SITE_SIZES)
JIT_SITE_CASES = ["feature_step-superframe", "feature_step-superframe_q",
                  "feature_step-single", "feature_step-single_q",
                  "encode_superframes", "encode_superframe",
                  "decode_packets", "decode_packet", "lloyd",
                  "kmeans_multi", "fit_pade", "feats_of", "eval_plc"]
JIT_SITE_SIZES = {"feature_step": (1, 128), "encode": (1, 128),
                  "decode": (1, 128),
                  "lloyd": (2000, 40000), "kmeans_multi": (2000, 40000),
                  "fit_pade": (1000, 2000), "feats_of": (1, 16),
                  "eval_plc": (1, 32)}
JIT_SITE_CALLS = 4


def _same(a, b) -> bool:
    from lpcnet_tpu_torch.utils import graphs
    la, sa = graphs.flatten(a)
    lb, sb = graphs.flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _jit_site(card, case, which):
    """(the jit, run): run() makes the case's inputs afresh from its seeds
    and calls the jit JIT_SITE_CALLS times, each call on what the last one
    left where the site carries a state; it returns the calls' outputs and
    the generator's state after them (None without a generator)."""
    from lpcnet_tpu_torch import data
    from lpcnet_tpu_torch import features as F
    from lpcnet_tpu_torch.cli import load_codebooks
    from lpcnet_tpu_torch.codec import codec, vq_train
    n = JIT_SITE_CALLS
    kind = case.split("-")[0]
    size = JIT_SITE_SIZES[kind.split("_")[0] if kind.startswith(
        ("encode", "decode")) else kind][which]
    rs = np.random.RandomState(size)

    def dev(x):
        return torch.as_tensor(x, device=card)

    if kind == "feature_step":
        mode, _, q = case.split("-")[1].partition("_")
        step = data.feature_step(q == "q", mode)
        pcm = dev((rs.randn(size, n * 8 * 160) * 3000).astype(np.float32))

        def run():
            st, outs = F.init_state(size, card), []
            for i in range(n):
                outs.append(step(st, pcm[:, i * 1280:(i + 1) * 1280]))
                st = outs[-1][0]
            return outs, None
        return step, run
    if kind.startswith(("encode", "decode")):
        cbs = load_codebooks(None, card)
        step = data.codec_step(kind, cbs)
        S = 2 if kind.endswith("s") else 1
        pcm = dev((rs.randn(size, n * S * 640) * 3000).astype(np.float32))
        _, feats, sps = F.compute_features(F.init_state(size, card), pcm,
                                           quantize_pitch=True)
        mem0 = torch.zeros((size, 18), device=card)
        bufs = codec.encode_superframes(cbs, feats, mem0, sps)[0]

        def args(i):
            sl = slice(i * S, (i + 1) * S)
            if kind == "encode_superframes":
                return feats[:, 4 * sl.start:4 * sl.stop], sps[sl]
            if kind == "encode_superframe":
                return feats[:, 4 * i:4 * i + 4], sps[i]
            return (bufs[:, sl],) if kind == "decode_packets" else \
                (bufs[:, i],)

        def run():
            mem, outs = mem0, []
            for i in range(n):
                a = args(i)
                outs.append(step(a[0], mem, *a[1:]) if kind.startswith(
                    "encode") else step(a[0], mem))
                mem = outs[-1][-1]
            return outs, None
        return step, run
    if kind in ("lloyd", "kmeans_multi"):
        multi = kind == "kmeans_multi"
        x = dev(rs.randn(*((size, 4, 18) if multi else (size, 17)))
                .astype(np.float32))
        cb0 = dev(rs.randn(16, 18 if multi else 17).astype(np.float32))
        step = vq_train.multi_update if multi else vq_train.lloyd
        # one generator, held by the graph (a new one is a new signature),
        # seeded afresh in each run
        gen = torch.Generator(device=card)

        def run():
            gen.manual_seed(0)
            cb, outs = cb0, []
            for _ in range(n):
                cb = step(cb, gen, x, True) if multi else step(cb, gen, x)
                outs.append(cb)
            return outs, gen.get_state()
        return step, run
    if kind == "fit_pade":
        from lpcnet_tpu_torch.tools import fit_pade
        from lpcnet_tpu_torch.training.optim import ScheduledAdam
        x, y, basis = (t[:size] for t in fit_pade.grid(card))
        opt = ScheduledAdam(lr=1e-3, b1=0.9, b2=0.9)

        def run():
            p = fit_pade.seed_params(card)
            st, outs = opt.init(p), []
            for _ in range(n):
                p, st = fit_pade.fit_step(p, st, x, y, basis, 1.0, 1.0, opt)
                outs.append((p, st))
            return outs, None
        return fit_pade.fit_step, run
    if kind == "feats_of":
        from lpcnet_tpu_torch.tools import train_codebooks
        xs = dev((rs.randn(n, size, 8 * 160) * 3000).astype(np.float32))
        return train_codebooks.feats_of, lambda: (
            [train_codebooks.feats_of(xs[i]) for i in range(n)], None)
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.tools import eval_plc
    params = convert.load_plc(device=card)
    xs = dev((rs.randn(n, size, 12, 57) * 0.5).astype(np.float32))
    return eval_plc.forward, lambda: (
        [eval_plc.forward(params, xs[i]) for i in range(n)], None)


@pytest.mark.cuda
@pytest.mark.parametrize("which", [0, 1], ids=["small", "large"])
@pytest.mark.parametrize("case", JIT_SITE_CASES)
def test_jit_site_graphed_bit_identical_to_eager(card, case, which):
    """Each jit site's chain of calls, graphed (the first call eager, the
    second captured, it and the others replays), is bit-identical to the
    same chain under graphs.disabled(): every output and carried state,
    and the generator the k-means updates draw from ends in the same
    state. One capture per signature."""
    from lpcnet_tpu_torch.utils import graphs
    step, run = _jit_site(card, case, which)
    step.clear()
    graphs.captures.clear()
    graphs.replays.clear()
    with graphs.disabled():
        eager = run()
    assert not graphs.captures and not graphs.replays
    graphed = run()
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: JIT_SITE_CALLS - 1}
    for k, (e, g) in enumerate(zip(eager[0], graphed[0])):
        assert _same(e, g), f"{case}: call {k + 1}"
    assert _same(eager[1], graphed[1]), f"{case}: the generator's state"
    # a second run replays the graph it made
    again = run()
    assert graphs.captures == {step.name: 1}
    assert graphs.replays == {step.name: 2 * JIT_SITE_CALLS - 1}
    assert all(_same(e, g) for e, g in zip(eager[0], again[0]))
    step.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 1024], ids=["B1", "B1024"])
def test_temperature_graphed_bit_identical_to_eager(card, batch):
    """synthesize_temperature on the card, two calls of 2 frames carrying
    the state: the conditioning jit and the sample step (one capture for
    the batch size, then a replay per sample) give the bits of the same
    calls under graphs.disabled(), pcm and every state leaf."""
    from lpcnet_tpu_torch.utils import graphs
    offs = (5 * np.arange(batch)) % (len(FEATS) - 4)
    feats = np.stack([FEATS[o:o + 4] for o in offs])
    v = Synthesizer(device=card)
    st0 = v.reset(batch, per_stream_rng=True)

    def run():
        st, outs = st0, []
        for i in range(2):
            st, pcm = v.synthesize_temperature(st, feats[:, 2 * i:2 * i + 2])
            outs.append((st, pcm))
        return outs

    with graphs.disabled():
        eager = run()
    graphs.captures.clear()
    graphs.replays.clear()
    graphed = run()
    name = "Synthesizer.synthesize_temperature"
    assert graphs.captures == {name + ".conditions": 1,
                               name + ".sample_step": 1}
    # the disabled run made the step's buffers without an eager call on
    # the card: the first graphed step is eager, the second captured
    assert graphs.replays == {name + ".conditions": 1,
                              name + ".sample_step": 2 * 2 * 160 - 1}
    assert all(_same(e, g) for e, g in zip(eager, graphed))
    assert torch.isfinite(graphed[-1][1]).all()


@pytest.fixture
def nccl_group(card):
    """A one-rank NCCL process group in this process."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    yield card
    dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [2, 4], ids=["B2", "B4"])
def test_dp_train_step_graphed_over_nccl(nccl_group, batch):
    """mesh.dp_train_step in a one-rank NCCL group: 3 steps graphed (the
    first eager, which makes the communicator, the second captured with
    both all-reduces inside, then a replay) are bit-identical to 3 steps
    under graphs.disabled() from the same parameters, batch and noise
    seed: parameters, Adam state, metrics and the generator's state."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.models import lpcnet
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.training import lpcnet_task
    from lpcnet_tpu_torch.utils import graphs
    card = nccl_group
    cfg = lpcnet.LPCNetConfig(gru_a_units=64, cond_size=32,
                              embed_sig_size=16, embed_pitch_size=8)
    params0 = convert.to_device(lpcnet.init_params(
        torch.Generator().manual_seed(0), cfg), card)
    opt = lpcnet_task.make_optimizer()
    batch_ = {k: torch.as_tensor(v, device=card)
              for k, v in mesh.dryrun_batch(batch, 2, cfg).items()}

    def run():
        gen = torch.Generator(device=card).manual_seed(1)
        p, st, outs = params0, opt.init(params0), []
        for _ in range(3):
            p, st, m = mesh.dp_train_step(p, st, batch_, cfg, opt, gen)
            outs.append((p, st, m))
        return outs, gen.get_state()

    mesh._dp_step.clear()
    with graphs.disabled():
        eager = run()
    graphs.captures.clear()
    graphs.replays.clear()
    graphed = run()
    assert graphs.captures == {"mesh.dp_train_step": 1}
    assert graphs.replays == {"mesh.dp_train_step": 2}
    for k, (e, g) in enumerate(zip(eager[0], graphed[0])):
        assert _same(e, g), f"step {k + 1}"
    assert torch.equal(eager[1], graphed[1])
    mesh._dp_step.clear()
