"""On-device verification of the built CUDA kernels (the port of
lpcnet_tpu/verify.py).

The CPU tests run the plain PyTorch versions only: a CUDA kernel has no
interpret mode. This module runs every kernel ON THE CARD at the shipped
configuration (shipped weights, full width) and gates it against its
oracle, the plain version (kernels/sample_scan.py) on the same device, with
the JAX package's gate names and thresholds:

1. INTEGER-EXACT gates: the KISS99 state after every kernel; excitation
   and the whole output waveform under full teacher forcing (the
   excitation chain is then a function of the target alone,
   lpcnet.c:256-261).
2. Free-running waveforms against the plain loop: >= 95% of the samples
   identical and correlation >= 0.999; tail forcing with active counts
   >= 95%; GRU states to 5e-3. (The plain versions sum in the kernels'
   order, so these have measured bit-identical; the thresholds are the JAX
   package's.) The JAX package's `*_vs_interpret` gates have no
   counterpart here.
3. The fused frame variants 'fuse' and 'opt' against the walked-tree
   kernel 'base': pcm, excitation and rng exact.
4. A run of StrictCausalPLCEngine through the kernels against the same
   engine through the plain versions: >= 90% identical, correlation
   >= 0.99 (lpcnet_plc.c:188-337 semantics).

Covered: synthesize_frames (flat, base, fuse, opt), synth_samples (fully
forced; force_from + n_active), teacher_advance, StrictCausalPLCEngine.
Any gate failure raises.
"""
from typing import Any, Dict

import numpy as np
import torch

from . import convert
from .constants import FRAME_SIZE, NB_TOTAL_FEATURES
from .device import resolve_device
from .kernels import sample_cuda, sample_scan
from .plc import StrictCausalPLCEngine
from .utils import graphs
from .vocoder import Synthesizer

_COND = ("cond_a", "cond_b", "lpc")


def _frac_equal(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a == b).float().mean())


def _corr(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(np.corrcoef(a.cpu().numpy().ravel(),
                             b.cpu().numpy().ravel())[0, 1])


def _max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _gate(report: Dict[str, Any], name: str, ok: bool, detail: Any):
    if ok and isinstance(detail, str):
        detail = "exact"        # boolean gates: the detail str describes
    report[name] = {"ok": bool(ok), "measured": detail}  # the failure only
    if not ok:
        raise RuntimeError(
            f"on-device kernel verification FAILED at gate '{name}': "
            f"{detail} (the built kernel disagrees with its oracle beyond "
            f"the recorded class)")


class _PlainStrictEngine(StrictCausalPLCEngine):
    """The strict engine with every synthesis call through the plain loop
    on the engine's device: the oracle of the strict_plc_step gate."""

    def step(self, state, pcm, lost):
        # eager: the oracle of the kernel engine's graphed step, not an
        # entry point (a graph of its plain sample loops is not needed)
        with graphs.disabled():
            return super().step(state, pcm, lost)

    def _synth_samples(self, synth_state, cond, nsamples, **kw):
        return sample_scan.synth_samples(
            self.tables, synth_state, {k: cond[k] for k in _COND}, self.cfg,
            nsamples, flat=self.variant == "flat", **kw)


@torch.no_grad()
def verify_on_device(batch: int = 1024, frames: int = 2,
                     plc_batch: int = 64, plc_frames: int = 6,
                     device=None) -> Dict[str, Any]:
    """Run every built kernel against its oracle on `device` (None: the
    card). Returns a per-gate report dict; raises on any failure."""
    dev = resolve_device(device)
    voc = Synthesizer(device=dev)
    cfg, tables = voc.cfg, voc.tables
    rs = np.random.RandomState(5)
    f = np.zeros((batch, frames, NB_TOTAL_FEATURES), np.float32)
    f[..., :18] = rs.randn(batch, frames, 18) * 0.3
    f[..., 18] = rs.uniform(-1, 1, (batch, frames))
    f[..., 19] = rs.uniform(0, 1, (batch, frames))
    full = voc.conditions(f)
    conds = {k: full[k].contiguous() for k in _COND}
    cond1 = {k: conds[k][:, 0].contiguous() for k in _COND}
    state = voc.reset(batch, per_stream_rng=True)
    report: Dict[str, Any] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "config": {"batch": batch, "frames": frames, "plc_batch": plc_batch,
                   "plc_frames": plc_frames},
    }

    # ---- free-running synthesis: each kernel variant vs the plain loop
    st_scan, pcm_scan = sample_scan.synthesize_frames(tables, state, conds,
                                                      cfg)
    runs = {}
    for variant in ("flat", "base"):
        st_c, pcm_c = runs[variant] = sample_cuda.synthesize_frames(
            tables, state, conds, cfg, variant=variant)
        _gate(report, f"{variant}_rng_exact",
              torch.equal(st_c["rng"], st_scan["rng"]),
              "rng state mismatch vs the plain loop")
        fr, corr = _frac_equal(pcm_c, pcm_scan), _corr(pcm_c, pcm_scan)
        _gate(report, f"{variant}_vs_scan", fr >= 0.95 and corr >= 0.999,
              {"exact_frac": round(fr, 6), "corr": round(corr, 6)})
    # ---- the fused variants leave the walked-tree kernel's bits
    st_b, pcm_b = runs["base"]
    for variant in ("fuse", "opt"):
        st_c, pcm_c = sample_cuda.synthesize_frames(tables, state, conds,
                                                    cfg, variant=variant)
        same = {k: torch.equal(st_c[k], st_b[k])
                for k in ("rng", "last_exc", "gru_a", "gru_b")}
        same["pcm"] = torch.equal(pcm_c, pcm_b)
        _gate(report, f"{variant}_vs_base_exact",
              same["pcm"] and same["last_exc"] and same["rng"],
              f"pcm, exc or rng mismatch vs base: {same}")
        report[f"{variant}_vs_base_exact"]["gru_exact"] = (
            same["gru_a"] and same["gru_b"])

    # ---- full teacher forcing: integer-exact through the kernel
    tgt = torch.as_tensor(np.round(rs.randn(batch, FRAME_SIZE) * 2500)
                          .astype(np.float32), device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pl_full = torch.full((batch,), FRAME_SIZE, **i32)
    s_tf, p_tf = sample_scan.synth_samples(tables, state, cond1, cfg,
                                           FRAME_SIZE, target=tgt,
                                           preload=pl_full)
    s_tp, p_tp = sample_cuda.synth_samples(tables, state, cond1, cfg,
                                           FRAME_SIZE, target=tgt,
                                           preload=pl_full, variant="flat")
    _gate(report, "teacher_forced_pcm_exact", torch.equal(p_tf, p_tp),
          "forced waveform mismatch")
    _gate(report, "teacher_forced_exc_exact",
          torch.equal(s_tf["last_exc"], s_tp["last_exc"]), "exc mismatch")
    _gate(report, "teacher_forced_rng_exact",
          torch.equal(s_tf["rng"], s_tp["rng"]), "rng mismatch")
    ga = _max_abs(s_tf["gru_a"], s_tp["gru_a"])
    gb = _max_abs(s_tf["gru_b"], s_tp["gru_b"])
    _gate(report, "teacher_forced_gru_tol", ga < 5e-3 and gb < 5e-3,
          {"gru_a_max": ga, "gru_b_max": gb})

    # ---- tail forcing (force_from) + per-stream active counts
    ff = torch.as_tensor(rs.randint(40, FRAME_SIZE, batch), **i32)
    na = torch.as_tensor(rs.randint(0, FRAME_SIZE + 1, batch), **i32)
    s_ff, p_ff = sample_scan.synth_samples(tables, state, cond1, cfg,
                                           FRAME_SIZE, target=tgt,
                                           force_from=ff, n_active=na)
    s_fp, p_fp = sample_cuda.synth_samples(tables, state, cond1, cfg,
                                           FRAME_SIZE, target=tgt,
                                           force_from=ff, n_active=na,
                                           variant="flat")
    _gate(report, "force_from_rng_exact",
          torch.equal(s_ff["rng"], s_fp["rng"]), "rng mismatch")
    fr_ff = _frac_equal(p_ff, p_fp)
    _gate(report, "force_from_vs_scan", fr_ff >= 0.95,
          {"exact_frac": round(fr_ff, 6)})

    # ---- teacher_advance (PLC good-frame fast path): non-GRU state exact
    state_w, _ = sample_cuda.synth_samples(tables, state, cond1, cfg, 23)
    s_ta, _ = sample_scan.teacher_advance(tables, state_w, cond1, cfg, tgt)
    s_tb, _ = sample_cuda.teacher_advance(tables, state_w, cond1, cfg, tgt)
    ok = all(torch.equal(s_ta[k], s_tb[k])
             for k in ("last_sig", "last_exc", "deemph", "rng"))
    _gate(report, "teacher_advance_state_exact", ok,
          "non-GRU state mismatch")
    ga = _max_abs(s_ta["gru_a"], s_tb["gru_a"])
    _gate(report, "teacher_advance_gru_tol", ga < 5e-3, {"gru_a_max": ga})

    # ---- a strict-PLC run, through the kernels vs through the plain loop
    lp = voc.params
    pp = convert.load_plc(device=dev)
    pcm = (rs.randn(plc_batch, plc_frames * FRAME_SIZE) * 3000).astype(
        np.float32)
    lost = rs.uniform(size=(plc_batch, plc_frames)) < 0.3
    outs = {}
    for name, cls in (("kernel", StrictCausalPLCEngine),
                      ("plain", _PlainStrictEngine)):
        eng = cls(lp, pp, device=dev)
        _, outs[name] = eng.run(eng.init_state(plc_batch), pcm, lost)
    fr_plc = _frac_equal(outs["kernel"], outs["plain"])
    corr_plc = _corr(outs["kernel"], outs["plain"])
    blend = np.concatenate([np.zeros((plc_batch, 1), bool), lost[:, :-1]],
                           axis=1) & ~lost
    _gate(report, "strict_plc_step", fr_plc >= 0.90 and corr_plc >= 0.99,
          {"exact_frac": round(fr_plc, 6), "corr": round(corr_plc, 6),
           "lost_steps": int(lost.sum()), "blend_steps": int(blend.sum()),
           "good_steps": int((~lost & ~blend).sum())})

    report["ok"] = True
    return report


def summary_line(report: Dict[str, Any]) -> Dict[str, Any]:
    """One bench JSON line: 1.0 iff every gate passed."""
    gates = {k: v for k, v in report.items() if isinstance(v, dict)
             and "ok" in v}
    return {"metric": "on_device_verify",
            "value": 1.0 if all(g["ok"] for g in gates.values()) else 0.0,
            "unit": "pass", "vs_baseline": 1.0,
            "gates": {k: g["measured"] for k, g in gates.items()},
            "device": report.get("device", "?")}
