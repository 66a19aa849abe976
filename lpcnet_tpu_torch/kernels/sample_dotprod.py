"""DOT_PROD (int8) arithmetic of the reference's deployed build, emulated
exactly in plain PyTorch (the port of lpcnet_tpu/kernels/sample_dotprod.py,
which is a lax.scan twin of the sample loop, not a Pallas kernel).

The reference's default build runs the two GRU matvecs of the sample
network in quantized form: weights pre-quantized to int8 at scale 128
(clip(round(128*w), -128, 127), dump_lpcnet.py:57-61, 85-122), activations
quantized online per step, 8x4-block dot products, the result rescaled by
SCALE_1 = 1/(128*127) (src/vec.h:200-340). Two flavours:

  * signed (portable C, vec.h:274-340): x_i8 = floor(.5 + 127*x), regular
    biases;
  * unsigned+SU (AVX2/NEON, vec_avx.h:690-906, vec.h:204-270 with
    USE_SU_BIAS): x_u8 = 127 + floor(.5 + 127*x), with biases that
    pre-compensate the +127 offset, subias = bias - sum_rows(W_q)/128
    (dump_lpcnet.py:139-141, 190-193).

The C's float accumulation order is kept: each 4-column group dot is an
exact integer (4 products below 2^15, summed below 2^17), and the groups
are folded into the bias*SCALE accumulator one at a time in ascending
column order in float32, as sgemv_accum8x4 does (vec.h:206-340). The
group dots are float32 products of small integers: exact in any summing
order, so a batched matmul computes them; on the card they refuse to run
while torch.backends.cuda.matmul.allow_tf32 is set. The fold is an
explicit loop: a GPU sum fixes no order.

Eager PyTorch rounds every operation on its own, so a product is rounded
before the add that follows it, as the C (no FMA) does. The JAX package
needs min(p, FLT_MAX) to stop XLA's CPU backend from contracting the pair;
_mul keeps that form so that it equals the JAX value in every case,
overflow included (the C gives inf there). No addcmul, addmm or lerp
appears where the C rounds twice, so the port's own approximate tanh,
sigmoid and lin2ulaw are the C's two-rounded forms as they stand (their
divisions take a tensor divisor: on CUDA, PyTorch divides by a Python
scalar as a product with its reciprocal, which rounds differently).

The unquantized parts (the mu-law embeddings summed in float, the dual-FC
sampler, the frame-rate network) are those of the plain loop.
"""
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import refuse_tf32
from ..ops import activations
from ..ops.mulaw import lin2ulaw, ulaw2lin
from .sample_scan import _sample_tree

SCALE = float(np.float32(128.0 * 127.0))
# the C computes 1.f/128.f/127.f left to right: (1/128 exact) / 127
SCALE_1 = float(np.float32(np.float32(1.0 / 128.0) / np.float32(127.0)))
FLT_MAX = float(np.finfo(np.float32).max)
QUANTIZED = ("qr_a", "qi_b", "qr_b")


def _quant_w(w: torch.Tensor) -> torch.Tensor:
    """int8 quantization at scale 128 (dump_lpcnet.py:57-61), as int32;
    torch.round rounds half to even, as jnp.round does."""
    return torch.clamp(torch.round(w.to(torch.float32) * 128.0),
                       -128, 127).to(torch.int32)


def quantize_tables(tables: Dict[str, Any], cfg,
                    su_bias: bool = False) -> Dict[str, Any]:
    """The DOT_PROD inference tables from the float sample tables
    (models/lpcnet.py::precompute_sample_tables), on their device.

    su_bias=False: the portable-C flavour (signed activations);
    su_bias=True: the AVX/NEON flavour (unsigned activations, SU biases).
    Keys as in the JAX package (diag_a, qr_a, qi_b, qr_b int32, br_a,
    bi_b_extra, br_b, su), plus "groups": each quantized matrix (K, O) as
    float32 (K/4, 4, O), the operand of the group dots."""
    na = cfg.gru_a_units
    wr_a = tables["wr_a"].to(torch.float32)                  # (na, 3na)
    # the diagonal stays float, removed from the quantized blocks
    # (export_ref.export_lpcnet_arrays, dump_lpcnet.py:450-460)
    diag = torch.cat([torch.diagonal(wr_a[:, k * na:(k + 1) * na])
                      for k in range(3)])                    # (3na,)
    eye3 = torch.eye(na, dtype=torch.float32,
                     device=wr_a.device).repeat(1, 3)
    q = {"diag_a": diag, "qr_a": _quant_w(wr_a * (1.0 - eye3)),
         "qi_b": _quant_w(tables["wi_b"]), "qr_b": _quant_w(tables["wr_b"]),
         "su": bool(su_bias)}
    br_a = tables["br_a"].to(torch.float32)
    br_b = tables["br_b"].to(torch.float32)
    if su_bias:
        # subias = bias - sum_rows(Wq)/128 (dump_lpcnet.py:139-141,190-193)
        q["br_a"] = br_a - q["qr_a"].sum(0).to(torch.float32) / 128.0
        q["bi_b_extra"] = -q["qi_b"].sum(0).to(torch.float32) / 128.0
        q["br_b"] = br_b - q["qr_b"].sum(0).to(torch.float32) / 128.0
    else:
        q["br_a"] = br_a
        q["bi_b_extra"] = torch.zeros_like(tables["br_b"],
                                           dtype=torch.float32)
        q["br_b"] = br_b
    q["groups"] = {k: q[k].to(torch.float32).reshape(
        q[k].shape[0] // 4, 4, q[k].shape[1]) for k in QUANTIZED}
    return q


def _mul(a, b):
    """fl32(a*b), then min(., FLT_MAX): the JAX package's form
    (sample_dotprod.py:111-128), whose min only stops XLA from contracting
    the product into a following add. Eager PyTorch never contracts, so
    here the min only keeps JAX's value on overflow (FLT_MAX, where the C
    gives inf)."""
    return torch.clamp(a * b, max=FLT_MAX)


# The C's approximations with every product rounded on its own: in eager
# PyTorch the port's own tanh_approx (vec.h:82-99), sigmoid_approx
# (vec.h:101-104) and lin2ulaw (common.h:47-58) are those forms, operation
# for operation, and equal the JAX package's _tanh_c, _sigmoid_c and
# _lin2ulaw_c (tests/test_torch_dotprod.py).
_tanh_c = activations.tanh_approx
_sigmoid_c = activations.sigmoid_approx
_lin2ulaw_c = lin2ulaw


def _qx(x: torch.Tensor, su: bool) -> torch.Tensor:
    """Online activation quantization (vec.h:243 / :281), int32."""
    xi = torch.floor(0.5 + _mul(127.0, x)).to(torch.int32)
    return xi + 127 if su else xi


def _qdot(bias: torch.Tensor, groups: torch.Tensor, x: torch.Tensor,
          su: bool) -> torch.Tensor:
    """out = (bias*SCALE + x_q^T W_q) * SCALE_1, the sgemv_accum8x4 contract
    (vec.h:206-236). groups: the quantized matrix as (K/4, 4, O) float32.
    The exact integer dot of each 4-column group, then the groups folded
    into the float32 accumulator one at a time in ascending order."""
    refuse_tf32(x, "the DOT_PROD group dots")
    B = x.shape[0]
    G = groups.shape[0]
    xg = _qx(x, su).to(torch.float32).reshape(B, G, 4).transpose(0, 1)
    parts = torch.bmm(xg, groups)                            # (G, B, O)
    acc = _mul(bias, SCALE).expand(B, groups.shape[-1])
    for g in range(G):
        acc = acc + parts[g]
    # _mul: the scaled result feeds the gate adds downstream
    return _mul(acc, SCALE_1)


def sample_step_dotprod(tables: Dict[str, Any], q: Dict[str, Any],
                        state: Dict[str, torch.Tensor],
                        cond_a: torch.Tensor, cond_b: torch.Tensor,
                        lpc: torch.Tensor, preemph: float,
                        target: Optional[torch.Tensor] = None,
                        teacher_mask: Optional[torch.Tensor] = None):
    """One sample step with the reference's quantized GRU arithmetic: the
    DOT_PROD twin of sample_scan.sample_step. The order of operations is
    compute_sparse_gru's (nnet.c:410-448) and compute_gruB's
    (nnet.c:326-372); the activations are always the C's approximations.
    Returns (new_state, out (B,) rounded samples)."""
    su = q["su"]
    na = q["diag_a"].shape[0] // 3
    nb = q["qr_b"].shape[0]
    grp = q["groups"]
    sig, act = _sigmoid_c, _tanh_c

    # the 16-term prediction in the C's order (lpcnet.c:252)
    last_sig = state["last_sig"]
    pred = torch.zeros_like(state["deemph"])
    for j in range(lpc.shape[-1]):
        pred = pred - _mul(last_sig[:, j], lpc[:, j])
    lsu = _lin2ulaw_c(last_sig[:, 0]).long()
    pu = _lin2ulaw_c(pred).long()
    # compute_gru_a_input (float, nnet.c:484-491)
    inp = (cond_a + tables["tbl_sig"][lsu] + tables["tbl_pred"][pu]
           + tables["tbl_exc"][state["last_exc"].long()])
    # sparse GRU-A: bias + diag*state (+ input on z and r), quantized dot
    h_a = state["gru_a"]
    base = q["br_a"] + _mul(q["diag_a"], h_a.repeat(1, 3))
    base = torch.cat([base[:, :2 * na] + inp[:, :2 * na], base[:, 2 * na:]],
                     dim=1)
    recur = _qdot(base, grp["qr_a"], h_a, su)
    z = sig(recur[:, :na])
    r = sig(recur[:, na:2 * na])
    hcand = act(_mul(recur[:, 2 * na:], r) + inp[:, 2 * na:])
    gru_a = _mul(z, h_a) + _mul(1.0 - z, hcand)

    # GRU-B: quantized input dot over gru_a, quantized recurrent dot
    zrh = _qdot(cond_b + q["bi_b_extra"], grp["qi_b"], gru_a, su)
    rec_b = _qdot(q["br_b"], grp["qr_b"], state["gru_b"], su)
    zb = sig(zrh[:, :nb] + rec_b[:, :nb])
    rb = sig(zrh[:, nb:2 * nb] + rec_b[:, nb:2 * nb])
    hb = act(zrh[:, 2 * nb:] + _mul(rec_b[:, 2 * nb:], rb))
    gru_b = _mul(zb, state["gru_b"]) + _mul(1.0 - zb, hb)

    # dual-FC: each row's 16-term dot sequentially (sample_mdense
    # nnet.c:195-199), channels combined as f1*tanh(s1) + f2*tanh(s2)
    # (:201-203); then the tree sampler
    dfc = tables["dual_fc"]
    y = dfc["b"].expand(gru_b.shape[0], *dfc["b"].shape)
    for j in range(gru_b.shape[-1]):
        y = y + _mul(gru_b[:, j, None, None], dfc["w"][:, j, :])
    ty = act(y)
    logits = (_mul(dfc["factor"][0], ty[:, 0])
              + _mul(dfc["factor"][1], ty[:, 1]))
    exc, rng = _sample_tree(logits, state["rng"])

    if target is not None:
        tf_sig = target - _mul(preemph, state["deemph"])
        exc = torch.where(teacher_mask, _lin2ulaw_c(tf_sig - pred), exc)
        pcm = torch.where(teacher_mask, tf_sig, pred + ulaw2lin(exc))
    else:
        pcm = pred + ulaw2lin(exc)
    deemph = pcm + _mul(preemph, state["deemph"])
    out = torch.floor(0.5 + torch.clamp(deemph, -32767.0, 32767.0))
    if target is not None:
        out = torch.where(teacher_mask, target, out)
    return {"gru_a": gru_a, "gru_b": gru_b,
            "last_sig": torch.cat([pcm[:, None], last_sig[:, :-1]], dim=-1),
            "last_exc": exc, "deemph": deemph, "rng": rng}, out


def synth_samples_dotprod(tables: Dict[str, Any], q: Dict[str, Any],
                          state: Dict[str, torch.Tensor],
                          cond: Dict[str, torch.Tensor], cfg, nsamples: int,
                          target: Optional[torch.Tensor] = None,
                          preload: Optional[torch.Tensor] = None
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """nsamples quantized steps under one condition set: the DOT_PROD twin
    of sample_scan.synth_samples, free-run, or with a target (B, nsamples)
    followed on samples [0, preload) (all of them when preload is None).
    Returns (state, (B, nsamples))."""
    ca, cb, lp = cond["cond_a"], cond["cond_b"], cond["lpc"]
    if target is not None and preload is None:
        preload = torch.full(ca.shape[:1], nsamples, dtype=torch.int32,
                             device=ca.device)
    outs = []
    for i in range(nsamples):
        if target is None:
            state, out = sample_step_dotprod(tables, q, state, ca, cb, lp,
                                             cfg.preemph)
        else:
            state, out = sample_step_dotprod(
                tables, q, state, ca, cb, lp, cfg.preemph,
                target=target[:, i], teacher_mask=i < preload)
        outs.append(out)
    return state, torch.stack(outs, dim=1)


def synthesize_frames_dotprod(tables: Dict[str, Any], q: Dict[str, Any],
                              state: Dict[str, torch.Tensor],
                              conds: Dict[str, torch.Tensor], cfg
                              ) -> Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]:
    """T-frame batched synthesis with the quantized sample network.
    conds: cond_a (B,T,3Na), cond_b (B,T,3Nb), lpc (B,T,16). Returns
    (new_state, pcm (B, T*frame_size))."""
    T = conds["cond_a"].shape[1]
    pcm = []
    for t in range(T):
        state, p = synth_samples_dotprod(
            tables, q, state, {k: conds[k][:, t]
                               for k in ("cond_a", "cond_b", "lpc")},
            cfg, cfg.frame_size)
        pcm.append(p)
    return state, torch.cat(pcm, dim=1)
