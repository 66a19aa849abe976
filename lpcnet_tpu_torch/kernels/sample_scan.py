"""The 16 kHz autoregressive synthesis loop in plain PyTorch, batched over
streams: the twin of lpcnet_tpu/kernels/sample_scan.py (free-run, teacher
forcing, per-stream active counts, the GRU-only teacher advance,
temperature sampling) and the oracle for the CUDA kernels
(csrc/sample_frame.cu, csrc/sample_frame_opt.cu, csrc/synth_samples.cu,
csrc/teacher_advance.cu). synthesize_frames_opt is the plain version of the
fused frame kernel (sample_pallas.py::_synth_loop_opt, variants 'fuse' and
'opt').

Per sample, per stream (reference lpcnet.c:235-271, nnet.c:163-214):
  1. order-16 LPC prediction
  2. mu-law of the last signal and of the prediction (bit-exact)
  3. GRU-A input = frame condition + 3 table rows, in the order
     cond_a + sig + pred + exc (sample_pallas.py:236-242)
  4. GRU-A (384), 5. GRU-B (16) with the frame condition
  6. dual-FC 256 logits, two KISS99 draws -> 8 thresholds, 8-bit tree
     sample, walked or flat (sample_pallas.py:99-127, 258-293)
  7. pcm = pred + ULAW2LIN[exc]; de-emphasis, clip, round
     (sample_pallas.py:308-313); on a teacher-forced step the excitation
     and the signal come from the target instead (sample_pallas.py:294-315)

Every sum runs in the CUDA kernel's order, one rounded float32 operation
at a time (seq_dot): sequential over the inner index, and the GRU-B input
product in KSLICE-row slices added in order. On the card the kernel and
this version then differ only where their transcendental functions do,
so the autoregressive loop cannot drift apart on a float near-tie. A
matmul library sums in its own order; that is why this version does not
call one, and why it is slow: it repeats the kernel's arithmetic and is no
yardstick of speed.

The three embedding tables may be float32 or bfloat16 (bf16_tables, the
JAX package's table_dtype of the frame kernels): a bfloat16 row enters the
GRU-A input sum widened to float32, exactly as the TPU kernel's one-hot
product with float32 accumulation takes it (sample_pallas.py:234-242), so
no step of the loop changes.

The state is a dict: gru_a (B,384) f32, gru_b (B,16) f32, last_sig (B,16)
f32, last_exc (B,) int32, deemph (B,) f32 and rng (B,4) int64 holding the
JAX package's uint32 KISS99 state.
"""
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..constants import LPC_ORDER
from ..models import layers
from ..ops import activations, kiss99
from ..ops.mulaw import lin2ulaw, ulaw2lin
from ..ops.tables import SAMPLING_LOGIT_TABLE, device_constant
from ..training.losses import tree_to_pdf

# The flat scorer's static tables (sample_pallas.py:99-127). The 8-bit tree
# walk visits heap node n_b(c) = 2^b + (c >> (8-b)) at level b and takes bit
# r_b(c) = (c >> (7-b)) & 1 on the way to leaf c. With cmp[n] = (thr_level(n)
# < logits[n]) for every heap node, the walked leaf is the unique c with
# cmp @ D[:, c] == popcount(c), D[n, c] = sum_b [n == n_b(c)] (2 r_b(c) - 1).
FLAT_SCORE_W = np.zeros((256, 256), np.float32)
FLAT_TARGET_LEAF = np.zeros((2, 256), np.float32)
for _c in range(256):
    for _b in range(8):
        FLAT_SCORE_W[(1 << _b) + (_c >> (8 - _b)), _c] = \
            2.0 * ((_c >> (7 - _b)) & 1) - 1.0
        FLAT_TARGET_LEAF[0, _c] += (_c >> (7 - _b)) & 1
    FLAT_TARGET_LEAF[1, _c] = _c
# tree level of each heap node (node 0 is unused and given level 0)
NODE_LEVEL = np.array([0] + [n.bit_length() - 1 for n in range(1, 256)],
                      np.int64)


# rows of wi_b per partial sum of the GRU-B input product (the kernel's
# KSLICE: 384 threads = 8 slices x 48 gate columns)
KSLICE = 48


def seq_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w (K, N) summed sequentially over k from the first
    product, each product and sum rounded on its own (no FMA)."""
    acc = x[..., 0:1] * w[0]
    for k in range(1, w.shape[0]):
        acc = acc + x[..., k:k + 1] * w[k]
    return acc


def sliced_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, K) @ w (K, N) as K/KSLICE sequential partial sums over
    consecutive row slices, added in slice order. K (the GRU-A width) must
    be a multiple of KSLICE."""
    B, K = x.shape
    if K % KSLICE:
        raise ValueError(f"the GRU-B input product sums in slices of "
                         f"{KSLICE} rows; gru_a_units={K} is not a multiple")
    nsl = K // KSLICE
    xs = x.reshape(B, nsl, KSLICE)
    ws = w.reshape(nsl, KSLICE, -1)
    acc = xs[:, :, 0:1] * ws[:, 0]
    for k in range(1, KSLICE):
        acc = acc + xs[:, :, k:k + 1] * ws[:, k]
    out = acc[:, 0]
    for j in range(1, nsl):
        out = out + acc[:, j]
    return out


def init_state(batch: int, cfg, rng_seed: Optional[np.ndarray] = None,
               device=None) -> Dict[str, torch.Tensor]:
    """Fresh synthesis state (lpcnet_reset, lpcnet.c:174-182)."""
    if rng_seed is None:
        rng_seed = kiss99.batched_seed(batch)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "gru_a": torch.zeros((batch, cfg.gru_a_units), **f32),
        "gru_b": torch.zeros((batch, cfg.gru_b_units), **f32),
        "last_sig": torch.zeros((batch, LPC_ORDER), **f32),
        "last_exc": torch.full((batch,), 128, dtype=torch.int32,
                               device=device),        # lin2ulaw(0)
        "deemph": torch.zeros((batch,), **f32),
        "rng": kiss99.to_tensor(rng_seed, device),
    }


def reset_like(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """init_state's fresh state for the streams of `state`, with `state`'s
    RNG kept: made on its device from its leaves, with no host seed to
    upload (a CUDA graph can capture it)."""
    new = {k: torch.zeros_like(v) for k, v in state.items()}
    new["last_exc"] = torch.full_like(state["last_exc"], 128)  # lin2ulaw(0)
    new["rng"] = state["rng"]
    return new


def _thresholds(rng: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two KISS99 draws -> (B, 8) sampling thresholds (bytes of the draws,
    low byte first, through SAMPLING_LOGIT_TABLE) and the new rng."""
    tbl = device_constant(SAMPLING_LOGIT_TABLE, rng.device)
    rng, r1 = kiss99.kiss99_next(rng)
    rng, r2 = kiss99.kiss99_next(rng)
    byts = [(r >> (8 * k)) & 0xFF for r in (r1, r2) for k in range(4)]
    return tbl[torch.stack(byts, dim=-1)], rng


def _walk_tree(logits: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """The 8-level walk of the sampling tree (nnet.c:186-211) under the
    thresholds thr (B, 8). Returns exc (B,) int32."""
    val = torch.zeros(logits.shape[:-1], dtype=torch.int64,
                      device=logits.device)
    for b in range(8):
        logit = torch.gather(logits, -1, (val | (1 << b))[..., None])[..., 0]
        val = (val << 1) | (thr[..., b] < logit).to(torch.int64)
    return val.to(torch.int32)


def _sample_tree(logits: torch.Tensor, rng: torch.Tensor):
    """Hierarchical 8-bit sampling by walking the tree (sample_mdense,
    nnet.c:163-214). logits: (B, 256) before sigmoid. Returns (exc (B,)
    int32, new rng)."""
    thr, rng = _thresholds(rng)
    return _walk_tree(logits, thr), rng


def _sample_flat(logits: torch.Tensor, rng: torch.Tensor):
    """The same sample, scoring the tree flat: compare every heap node with
    its level's threshold, one product with FLAT_SCORE_W scores all 256
    leaves, the walked leaf is the one whose score is its popcount. All
    operands are small integers, so the product is exact."""
    thr, rng = _thresholds(rng)
    dev = logits.device
    thr_cols = thr[:, device_constant(NODE_LEVEL, dev)]
    cmp = (thr_cols < logits).to(torch.float32)
    dots = cmp @ device_constant(FLAT_SCORE_W, dev)
    tgt = device_constant(FLAT_TARGET_LEAF, dev)
    exc = torch.where(dots == tgt[0], tgt[1], 0.0).sum(-1)
    return exc.to(torch.int32), rng


def _sample_temperature(logits: torch.Tensor, rng: torch.Tensor,
                        temp_exp: torch.Tensor, approx: bool):
    """Temperature/PDF-floor sampling (training_tf2/test_lpcnet.py:131-138):
    expand the tree nodes to a 256-way pdf, sharpen voiced frames with
    p *= p^temp_exp, cut the tail below 0.002, and draw by inverse CDF from
    ONE KISS99 uniform. temp_exp: (B,). A quality knob; the tree sampler is
    the C-bit-exact path. Returns (exc (B,) int32, new rng)."""
    pdf = tree_to_pdf(activations.get("sigmoid", approx)(logits))
    pdf = pdf * torch.pow(torch.clamp(pdf, min=1e-18), temp_exp[..., None])
    pdf = pdf / (1e-18 + pdf.sum(-1, keepdim=True))
    pdf = torch.clamp(pdf - 0.002, min=0.0)
    pdf = pdf / (1e-8 + pdf.sum(-1, keepdim=True))
    rng, r = kiss99.kiss99_next(rng)
    u = r.to(torch.float32) / 4294967296.0
    exc = (torch.cumsum(pdf, dim=-1) < u[..., None]).sum(-1)
    return torch.clamp(exc, 0, 255).to(torch.int32), rng


def _lpc_pred(sig: torch.Tensor, lpc: torch.Tensor) -> torch.Tensor:
    """-sum_k sig[..., k] * lpc[..., k], the 16 products added in order
    from k = 0 (the most recent sample), as the kernels add them."""
    prod = sig * lpc
    acc = prod[..., 0]
    for k in range(1, LPC_ORDER):
        acc = acc + prod[..., k]
    return -acc


def sample_step(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                cond_a: torch.Tensor, cond_b: torch.Tensor,
                lpc: torch.Tensor, approx: bool, preemph: float,
                flat: bool = False,
                target: Optional[torch.Tensor] = None,
                teacher_mask: Optional[torch.Tensor] = None,
                temp_exp: Optional[torch.Tensor] = None):
    """One 1/16000 s step for all streams. cond_*: (B, 3N), lpc: (B, 16).
    target (B,) with teacher_mask (B,) bool: where the mask is set the step
    follows the target (lpcnet.c:256-261) and emits it; the sampler runs and
    the RNG advances all the same. temp_exp (B,): the sharpening exponent
    of temperature sampling, which takes the place of the tree sampler.
    Returns (new_state, out (B,) rounded samples)."""
    # 1. LPC prediction (lpcnet.c:252)
    pred = _lpc_pred(state["last_sig"], lpc)
    # 2-4. GRU-A from three table rows + the frame condition
    lsu = lin2ulaw(state["last_sig"][:, 0]).long()
    pu = lin2ulaw(pred).long()
    zrh_a = (cond_a + tables["tbl_sig"][lsu] + tables["tbl_pred"][pu]
             + tables["tbl_exc"][state["last_exc"].long()])
    h = state["gru_a"]
    gru_a = layers.gru_gates(h, zrh_a,
                             seq_dot(h, tables["wr_a"]) + tables["br_a"],
                             approx=approx)
    # 5. GRU-B
    zrh_b = cond_b + sliced_dot(gru_a, tables["wi_b"])
    h = state["gru_b"]
    gru_b = layers.gru_gates(h, zrh_b,
                             seq_dot(h, tables["wr_b"]) + tables["br_b"],
                             approx=approx)
    # 6. dual-FC logits + tree sample
    dfc = tables["dual_fc"]
    act = activations.get("tanh", approx)
    y1, y2 = (act(seq_dot(gru_b, dfc["w"][c]) + dfc["b"][c])
              * dfc["factor"][c] for c in (0, 1))
    logits = y1 + y2
    if temp_exp is not None:
        exc, rng = _sample_temperature(logits, state["rng"], temp_exp,
                                       approx)
    else:
        exc, rng = (_sample_flat if flat else _sample_tree)(logits,
                                                            state["rng"])
    # 7. excitation -> signal, de-emphasis, clip, round (lpcnet.c:260-269)
    if target is not None:
        tf_sig = target - preemph * state["deemph"]
        exc = torch.where(teacher_mask, lin2ulaw(tf_sig - pred), exc)
        pcm = torch.where(teacher_mask, tf_sig, pred + ulaw2lin(exc))
    else:
        pcm = pred + ulaw2lin(exc)
    last_sig = torch.cat([pcm[:, None], state["last_sig"][:, :-1]], dim=-1)
    deemph = pcm + preemph * state["deemph"]
    out = torch.floor(0.5 + torch.clamp(deemph, -32767.0, 32767.0))
    if target is not None:
        out = torch.where(teacher_mask, target, out)
    return {"gru_a": gru_a, "gru_b": gru_b, "last_sig": last_sig,
            "last_exc": exc, "deemph": deemph, "rng": rng}, out


def synthesize_frame(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                     cond_a: torch.Tensor, cond_b: torch.Tensor,
                     lpc: torch.Tensor, cfg, flat: bool = False):
    """frame_size free-run steps under one frame's conditions.
    Returns (new_state, pcm (B, frame_size))."""
    outs = []
    for _ in range(cfg.frame_size):
        state, out = sample_step(tables, state, cond_a, cond_b, lpc,
                                 cfg.approx, cfg.preemph, flat=flat)
        outs.append(out)
    return state, torch.stack(outs, dim=1)


def synth_samples(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                  cond: Dict[str, torch.Tensor], cfg, nsamples: int,
                  target: Optional[torch.Tensor] = None,
                  preload: Optional[torch.Tensor] = None,
                  n_active: Optional[torch.Tensor] = None,
                  force_from: Optional[torch.Tensor] = None,
                  flat: bool = False
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`nsamples` steps under ONE condition set, as the PLC engines call it
    for whole frames and half frames (lpcnet_synthesize_tail_impl,
    lpcnet.c:235-271).

    cond: cond_a (B,3Na), cond_b (B,3Nb), lpc (B,16). target: optional
    (B, nsamples); preload (B,) int32: samples [0, preload) follow the
    target; force_from (B,) int32: samples [force_from, nsamples) follow it
    too. With a target and neither, the whole segment is forced; with
    force_from alone, preload is 0. n_active (B,) int32: on steps >=
    n_active a stream keeps its whole state, RNG included, and emits 0.
    Returns (state, (B, nsamples))."""
    ca, cb, lp = cond["cond_a"], cond["cond_b"], cond["lpc"]
    if target is not None and preload is None:
        preload = torch.full(ca.shape[:1], 0 if force_from is not None
                             else nsamples, dtype=torch.int32,
                             device=ca.device)
    outs = []
    for i in range(nsamples):
        if target is not None:
            tmask = i < preload
            if force_from is not None:
                tmask = tmask | (i >= force_from)
            new, out = sample_step(tables, state, ca, cb, lp, cfg.approx,
                                   cfg.preemph, flat=flat,
                                   target=target[:, i], teacher_mask=tmask)
        else:
            new, out = sample_step(tables, state, ca, cb, lp, cfg.approx,
                                   cfg.preemph, flat=flat)
        if n_active is not None:
            act = i < n_active
            new = {k: torch.where(act.reshape((-1,) + (1,) * (v.dim() - 1)),
                                  v, state[k]) for k, v in new.items()}
            out = torch.where(act, out, torch.zeros_like(out))
        state = new
        outs.append(out)
    return state, torch.stack(outs, dim=1)


def teacher_sequences(state: Dict[str, torch.Tensor],
                      cond: Dict[str, torch.Tensor], cfg,
                      target: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Everything but the GRU recurrences of a fully forced segment: under
    teacher forcing the signal and excitation chain is a function of the
    target alone. Returns lsu, pu, exc_prev ((B, ns) int32 row indices of
    the three GRU-A tables) and last_sig, last_exc, deemph, the non-GRU
    state after the segment. Every value equals the forced sample loop's
    bit for bit: the de-emphasis chain repeats sample_step's operations
    one sample at a time, and the prediction adds its 16 products in
    sample_step's order."""
    preemph = cfg.preemph
    ns = target.shape[1]
    d = state["deemph"]
    tf = []
    for i in range(ns):
        pd = preemph * d
        tf.append(target[:, i] - pd)
        d = tf[-1] + pd
    tf = torch.stack(tf, dim=1)                          # (B, ns) forced pcm
    sig_seq = torch.cat([state["last_sig"].flip(-1), tf], dim=1)
    # lags[:, i, j] = the signal j+1 samples before sample i
    lags = torch.stack(
        [sig_seq[:, LPC_ORDER - 1 - j:LPC_ORDER - 1 - j + ns]
         for j in range(LPC_ORDER)], dim=-1)             # (B, ns, 16)
    pred = _lpc_pred(lags, cond["lpc"][:, None, :])
    exc = lin2ulaw(tf - pred)
    return {"lsu": lin2ulaw(lags[..., 0]), "pu": lin2ulaw(pred),
            "exc_prev": torch.cat([state["last_exc"][:, None], exc[:, :-1]],
                                  dim=1),
            "last_sig": sig_seq[:, -LPC_ORDER:].flip(-1).contiguous(),
            "last_exc": exc[:, -1].contiguous(), "deemph": d}


def teacher_gru_advance(tables: Dict[str, Any], gru_a: torch.Tensor,
                        gru_b: torch.Tensor, cond: Dict[str, torch.Tensor],
                        seqs: Dict[str, torch.Tensor], cfg
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two GRU recurrences over a forced segment from its table
    indices seqs["lsu"], ["pu"], ["exc_prev"] ((B, ns) each), summing in the
    sample loop's order. Returns the new (gru_a, gru_b)."""
    lsu, pu, exc_prev = (seqs[k].long() for k in ("lsu", "pu", "exc_prev"))
    for i in range(lsu.shape[1]):
        zrh_a = (cond["cond_a"] + tables["tbl_sig"][lsu[:, i]]
                 + tables["tbl_pred"][pu[:, i]]
                 + tables["tbl_exc"][exc_prev[:, i]])
        gru_a = layers.gru_gates(
            gru_a, zrh_a, seq_dot(gru_a, tables["wr_a"]) + tables["br_a"],
            approx=cfg.approx)
        zrh_b = cond["cond_b"] + sliced_dot(gru_a, tables["wi_b"])
        gru_b = layers.gru_gates(
            gru_b, zrh_b, seq_dot(gru_b, tables["wr_b"]) + tables["br_b"],
            approx=cfg.approx)
    return gru_a, gru_b


def teacher_advance(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                    cond: Dict[str, torch.Tensor], cfg, target: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """State advance over a FULLY teacher-forced segment without the
    sample loop: what synth_samples(..., target=target) leaves as state,
    bit for bit, with only the two GRU recurrences run per sample (no
    dual-FC, no sampler; the forced output is the target itself). The plain
    version of csrc/teacher_advance.cu, which computes all of it in one
    launch.

    cond: cond_a (B,3Na), cond_b (B,3Nb), lpc (B,16); target (B, ns).
    Returns (new_state, target)."""
    seqs = teacher_sequences(state, cond, cfg, target)
    gru_a, gru_b = teacher_gru_advance(tables, state["gru_a"],
                                       state["gru_b"], cond, seqs, cfg)
    return {"gru_a": gru_a, "gru_b": gru_b, "last_sig": seqs["last_sig"],
            "last_exc": seqs["last_exc"], "deemph": seqs["deemph"],
            "rng": kiss99.kiss99_advance(state["rng"],
                                        2 * target.shape[1])}, target


def synthesize_frames(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                      conds: Dict[str, torch.Tensor], cfg,
                      flat: bool = False,
                      target: Optional[torch.Tensor] = None,
                      preload: Optional[torch.Tensor] = None,
                      temp_exp: Optional[torch.Tensor] = None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Synthesis of T frames for B streams.

    conds: cond_a (B,T,3Na), cond_b (B,T,3Nb), lpc (B,T,16) [frame rate].
    target: optional (B, T*frame_size) teacher waveform with preload (B, T)
    int32: per frame, samples [0, preload) follow the target
    (lpcnet_synthesize_impl's preload argument). temp_exp: optional (B, T)
    per-frame sharpening exponents (temperature sampling). Returns
    (new_state, pcm (B, T*frame_size) float32 rounded samples)."""
    B, T = conds["cond_a"].shape[:2]
    fs = cfg.frame_size
    if target is not None and (preload is None or temp_exp is not None):
        raise ValueError("a target needs preload counts and excludes "
                         "temp_exp")
    pcm = []
    for t in range(T):
        cond = {k: conds[k][:, t] for k in ("cond_a", "cond_b", "lpc")}
        if target is not None:
            state, p = synth_samples(
                tables, state, cond, cfg, fs, flat=flat,
                target=target[:, t * fs:(t + 1) * fs], preload=preload[:, t])
        elif temp_exp is not None:
            outs = []
            for _ in range(fs):
                state, out = sample_step(
                    tables, state, cond["cond_a"], cond["cond_b"],
                    cond["lpc"], cfg.approx, cfg.preemph,
                    temp_exp=temp_exp[:, t])
                outs.append(out)
            p = torch.stack(outs, dim=1)
        else:
            state, p = synthesize_frame(tables, state, cond["cond_a"],
                                        cond["cond_b"], cond["lpc"], cfg,
                                        flat=flat)
        pcm.append(p)
    return state, torch.cat(pcm, dim=1).reshape(B, T * fs)


STATE_KEYS = ("gru_a", "gru_b", "last_sig", "last_exc", "deemph", "rng")
# the per-frame inputs of a temperature sample step
TEMPERATURE_INPUTS = ("cond_a", "cond_b", "lpc", "texp")


def temperature_buffers(state: Dict[str, torch.Tensor],
                        conds: Dict[str, torch.Tensor], cfg
                        ) -> Dict[str, torch.Tensor]:
    """The buffers temperature_step_ works in, for the streams of `state`
    and the frame conditions `conds` (B, T, ...): the state's six leaves,
    one frame's cond_a, cond_b, lpc and texp, the frame's pcm (B,
    frame_size) and the position of the next sample in it, pos (1,)
    int64; on the state's device, their values undefined."""
    bufs = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    bufs.update({k: torch.empty_like(conds[k][:, 0])
                 for k in TEMPERATURE_INPUTS})
    B = state["rng"].shape[0]
    bufs["pcm"] = torch.empty((B, cfg.frame_size), dtype=torch.float32,
                              device=state["rng"].device)
    bufs["pos"] = torch.zeros(1, dtype=torch.int64,
                              device=state["rng"].device)
    return bufs


def temperature_step_(tables: Dict[str, Any], cfg,
                      bufs: Dict[str, torch.Tensor]) -> None:
    """One temperature sample step (sample_step with temp_exp) in place on
    temperature_buffers: the state leaves take the step's new state, the
    sample goes to pcm[:, pos] and pos advances by one. The arithmetic is
    sample_step's, so the bits are those of synthesize_frames(...,
    temp_exp=...)."""
    new, out = sample_step(tables, {k: bufs[k] for k in STATE_KEYS},
                           bufs["cond_a"], bufs["cond_b"], bufs["lpc"],
                           cfg.approx, cfg.preemph, temp_exp=bufs["texp"])
    for k in STATE_KEYS:
        bufs[k].copy_(new[k])
    bufs["pcm"].index_copy_(1, bufs["pos"], out[:, None])
    bufs["pos"].add_(1)


def synthesize_frames_temperature(step, state: Dict[str, torch.Tensor],
                                  conds: Dict[str, torch.Tensor], cfg
                                  ) -> Tuple[Dict[str, torch.Tensor],
                                             torch.Tensor]:
    """Temperature synthesis of T frames through `step`, a call that runs
    temperature_step_ on its buffers step.bufs (temperature_buffers; a
    utils/graphs.loop_step replays it as one CUDA graph): the state is
    copied in, then per frame its cond_a, cond_b, lpc and texp, and
    frame_size steps fill the frame's pcm. conds: cond_a, cond_b, lpc
    (B, T, ...) and texp (B, T). Returns (new_state, pcm (B, T*frame_size)),
    what synthesize_frames(..., temp_exp=texp) returns, bit for bit."""
    bufs = step.bufs
    for k in STATE_KEYS:
        bufs[k].copy_(state[k])
    pcm = []
    for t in range(conds["cond_a"].shape[1]):
        for k in TEMPERATURE_INPUTS:
            bufs[k].copy_(conds[k][:, t])
        bufs["pos"].zero_()
        for _ in range(cfg.frame_size):
            step()
        pcm.append(bufs["pcm"].clone())
    return {k: bufs[k].clone() for k in STATE_KEYS}, torch.cat(pcm, dim=1)


TABLES = ("tbl_sig", "tbl_pred", "tbl_exc")
TABLE_DTYPES = (torch.float32, torch.bfloat16)


def bf16_tables(tables: Dict[str, Any]) -> Dict[str, Any]:
    """A tables dict whose three embedding tables are rounded to bfloat16
    (round to nearest even, as the JAX package's astype(jnp.bfloat16)):
    the operand of the frame kernels' bf16 instances. A new dict; the
    other entries are shared, the fused operands built from the float32
    tables are not carried over."""
    out = {k: v for k, v in tables.items() if not k.startswith("fused")}
    out.update({k: tables[k].to(torch.bfloat16).contiguous()
                for k in TABLES})
    return out


def table_dtype(tables: Dict[str, Any]) -> torch.dtype:
    """The element type of the three embedding tables: float32 or
    bfloat16, the same for all three."""
    dtypes = {tables[k].dtype for k in TABLES}
    if len(dtypes) != 1 or not dtypes <= set(TABLE_DTYPES):
        raise TypeError(f"the embedding tables must all be float32 or all "
                        f"bfloat16, not {sorted(map(str, dtypes))}")
    return dtypes.pop()


def fused_operands(tables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The operands the fused frame kernel takes in place of the three
    embedding tables and the two dual-FC channels, as
    synthesize_frame_pallas builds them (sample_pallas.py:1000-1008):
    tbl_cat (768, 3Na) = [tbl_sig; tbl_pred; tbl_exc] in the tables' type,
    dfc_w12 (Nb, 512) = [w[0] | w[1]] and dfc_b12 (512,) = [b[0], b[1]].
    Built once per tables dict (on the tables' device) and kept in it under
    "fused", or "fused_bf16" for bfloat16 tables, so that operands of the
    two table types never share an entry."""
    key = "fused" if table_dtype(tables) == torch.float32 else "fused_bf16"
    if key not in tables:
        dfc = tables["dual_fc"]
        tables[key] = {
            "tbl_cat": torch.cat([tables["tbl_sig"], tables["tbl_pred"],
                                  tables["tbl_exc"]], dim=0).contiguous(),
            "dfc_w12": torch.cat([dfc["w"][0], dfc["w"][1]],
                                 dim=1).contiguous(),
            "dfc_b12": torch.cat([dfc["b"][0], dfc["b"][1]]).contiguous()}
    return tables[key]


def synthesize_frame_opt(tables: Dict[str, Any],
                         state: Dict[str, torch.Tensor],
                         cond_a: torch.Tensor, cond_b: torch.Tensor,
                         lpc: torch.Tensor, cfg, pipeline_thr: bool = True,
                         nsamples: Optional[int] = None):
    """`nsamples` (default frame_size) free-run steps in the ordering of
    sample_pallas.py::_synth_loop_opt, the plain version of the fused frame
    kernel (csrc/sample_frame_opt.cu): the three table rows come from ONE
    table tbl_cat at lsu, 256 + pu and 512 + exc, the dual-FC is ONE
    (Nb, 512) product, and with pipeline_thr ('opt'; False is 'fuse') step
    i draws the thresholds of step i + 1, the last lookahead draw rolled
    back. Every sum runs in sample_step's order (the four GRU-A terms as
    ((cond_a + sig) + pred) + exc, each of the 512 dual-FC columns over
    k = 0..15), so state and pcm equal the walked-tree loop's bit for bit.
    Returns (new_state, pcm (B, nsamples))."""
    fused = fused_operands(tables)
    tbl_cat, w12, b12 = fused["tbl_cat"], fused["dfc_w12"], fused["dfc_b12"]
    factor = tables["dual_fc"]["factor"]
    nl = factor.shape[-1]
    act = activations.get("tanh", cfg.approx)
    ns = cfg.frame_size if nsamples is None else nsamples
    gru_a, gru_b, last_sig = state["gru_a"], state["gru_b"], state["last_sig"]
    exc, deemph, rng = state["last_exc"], state["deemph"], state["rng"]
    thr = None
    if pipeline_thr:
        thr, rng = _thresholds(rng)
    outs = []
    for i in range(ns):
        if pipeline_thr:
            # the NEXT sample's thresholds: independent of this sample's
            # chain; the draw of the last step is rolled back
            thr_n, rng_n = _thresholds(rng)
            if i == ns - 1:
                rng_n = rng
        else:
            thr, rng_n = _thresholds(rng)
            thr_n = thr
        pred = _lpc_pred(last_sig, lpc)
        lsu = lin2ulaw(last_sig[:, 0]).long()
        pu = lin2ulaw(pred).long()
        zrh_a = (cond_a + tbl_cat[lsu] + tbl_cat[nl + pu]
                 + tbl_cat[2 * nl + exc.long()])
        gru_a = layers.gru_gates(
            gru_a, zrh_a, seq_dot(gru_a, tables["wr_a"]) + tables["br_a"],
            approx=cfg.approx)
        zrh_b = cond_b + sliced_dot(gru_a, tables["wi_b"])
        gru_b = layers.gru_gates(
            gru_b, zrh_b, seq_dot(gru_b, tables["wr_b"]) + tables["br_b"],
            approx=cfg.approx)
        y12 = act(seq_dot(gru_b, w12) + b12)                   # (B, 512)
        logits = y12[:, :nl] * factor[0] + y12[:, nl:] * factor[1]
        exc = _walk_tree(logits, thr)
        pcm = pred + ulaw2lin(exc)
        last_sig = torch.cat([pcm[:, None], last_sig[:, :-1]], dim=-1)
        deemph = pcm + cfg.preemph * deemph
        outs.append(torch.floor(0.5 + torch.clamp(deemph, -32767.0,
                                                  32767.0)))
        rng, thr = rng_n, thr_n
    return {"gru_a": gru_a, "gru_b": gru_b, "last_sig": last_sig,
            "last_exc": exc, "deemph": deemph,
            "rng": rng}, torch.stack(outs, dim=1)


def synthesize_frames_opt(tables: Dict[str, Any],
                          state: Dict[str, torch.Tensor],
                          conds: Dict[str, torch.Tensor], cfg,
                          pipeline_thr: bool = True
                          ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Free-run synthesis of T frames through synthesize_frame_opt; the
    arguments and the result of synthesize_frames."""
    B, T = conds["cond_a"].shape[:2]
    pcm = []
    for t in range(T):
        state, p = synthesize_frame_opt(
            tables, state, conds["cond_a"][:, t], conds["cond_b"][:, t],
            conds["lpc"][:, t], cfg, pipeline_thr=pipeline_thr)
        pcm.append(p)
    return state, torch.cat(pcm, dim=1).reshape(B, T * cfg.frame_size)
