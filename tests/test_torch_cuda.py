"""The CUDA sample kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips where torch finds no CUDA device. This file
imports neither jax nor lpcnet_tpu, so it also runs on a machine with the
card and without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The sample loop's two launch plans are forced through launch_plan's input,
the card's cluster count (sample_cuda._plan_forced): the card's own count
gives plan L up to its boundary (8 streams per cluster), 0 gives plan T.
"""
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
