"""The frame sample kernel (csrc/sample_frame.cu) bound to PyTorch: the
counterpart of synthesize_frame_pallas / synthesize_frames_pallas in
lpcnet_tpu/kernels/sample_pallas.py.

For tensors on the CPU the functions run the plain PyTorch version
(kernels/sample_scan.py). For CUDA tensors they launch the kernel, one
launch per frame on the current stream, or raise; there is no fallback.
`launches[variant]` counts kernel launches of each sampler variant (and
nothing else), so a run can show that it went through the kernel.

The state dict layout is sample_scan's. The returned state is new memory:
the kernel updates it in place from frame to frame.
"""
import ctypes
from typing import Any, Dict, Tuple

import torch

from ..constants import DUAL_FC_OUT, FRAME_SIZE, GRU_A_SIZE, GRU_B_SIZE, \
    LPC_ORDER
from ..ops.mulaw import ULAW2LIN_TABLE
from ..ops.tables import SAMPLING_LOGIT_TABLE
from . import _build, sample_scan

VARIANTS = ("flat", "base")
# the widths the kernel is compiled for (csrc/sample_frame.cu)
NA, NB, NL = GRU_A_SIZE, GRU_B_SIZE, DUAL_FC_OUT

launches = {"flat": 0, "base": 0}


class _Params(ctypes.Structure):
    """ctypes twin of LpcnetFrameParams in csrc/sample_frame.cu."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("cond_a", "cond_b", "lpc")]
        + [(n, ctypes.c_longlong)
           for n in ("ca_stride", "cb_stride", "lpc_stride")]
        + [(n, ctypes.c_void_p) for n in (
            "tbl_sig", "tbl_pred", "tbl_exc", "wr_a", "br_a", "wi_b", "wr_b",
            "br_b", "dfc_w", "dfc_b", "dfc_f", "logit_tbl",
            "gru_a_in", "gru_b_in", "sig_in", "exc_in", "deemph_in",
            "rng_in", "gru_a_out", "gru_b_out", "sig_out", "exc_out",
            "deemph_out", "rng_out", "pcm")]
        + [("pcm_stride", ctypes.c_longlong), ("batch", ctypes.c_int),
           ("preemph", ctypes.c_float)])


def _lib() -> ctypes.CDLL:
    lib = _build.load("sample_frame")
    if not getattr(lib, "_lpcnet_typed", False):
        lib.lpcnet_sample_frame.argtypes = [ctypes.POINTER(_Params),
                                            ctypes.c_int, ctypes.c_void_p]
        lib.lpcnet_sample_frame.restype = ctypes.c_int
        lib.lpcnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lpcnet_cuda_error_string.restype = ctypes.c_char_p
        lib._lpcnet_typed = True
    return lib


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cfg(cfg):
    if (cfg.gru_a_units, cfg.gru_b_units, cfg.pcm_levels, cfg.frame_size,
            cfg.lpc_order) != (NA, NB, NL, FRAME_SIZE, LPC_ORDER):
        raise ValueError("the CUDA frame kernel is compiled for GRU-A 384, "
                         "GRU-B 16, 256 levels and 160-sample frames")
    if cfg.approx:
        raise ValueError("the CUDA frame kernel computes exact activations; "
                         "cfg.approx needs the CPU path")


def synthesize_frames(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                      conds: Dict[str, torch.Tensor], cfg,
                      variant: str = "flat"
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Free-run synthesis of T frames for B streams.

    conds: cond_a (B,T,3Na), cond_b (B,T,3Nb), lpc (B,T,16). variant: 'flat'
    (flat sampling tree, K1) or 'base' (walked tree, K2); the two give the
    same bits. Returns (new_state, pcm (B, T*160) float32)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    flat = variant == "flat"
    device = conds["cond_a"].device
    if device.type == "cpu":
        return sample_scan.synthesize_frames(tables, state, conds, cfg,
                                             flat=flat)
    if device.type != "cuda":
        raise ValueError(f"no frame kernel for device {device}")
    _check_cfg(cfg)
    B, T = conds["cond_a"].shape[:2]
    f32, dfc = torch.float32, tables["dual_fc"]
    for name, t, shape in (
            ("cond_a", conds["cond_a"], (B, T, 3 * NA)),
            ("cond_b", conds["cond_b"], (B, T, 3 * NB)),
            ("lpc", conds["lpc"], (B, T, LPC_ORDER)),
            ("tbl_sig", tables["tbl_sig"], (NL, 3 * NA)),
            ("tbl_pred", tables["tbl_pred"], (NL, 3 * NA)),
            ("tbl_exc", tables["tbl_exc"], (NL, 3 * NA)),
            ("wr_a", tables["wr_a"], (NA, 3 * NA)),
            ("br_a", tables["br_a"], (3 * NA,)),
            ("wi_b", tables["wi_b"], (NA, 3 * NB)),
            ("wr_b", tables["wr_b"], (NB, 3 * NB)),
            ("br_b", tables["br_b"], (3 * NB,)),
            ("dual_fc.w", dfc["w"], (2, NB, NL)),
            ("dual_fc.b", dfc["b"], (2, NL)),
            ("dual_fc.factor", dfc["factor"], (2, NL)),
            ("gru_a", state["gru_a"], (B, NA)),
            ("gru_b", state["gru_b"], (B, NB)),
            ("last_sig", state["last_sig"], (B, LPC_ORDER)),
            ("deemph", state["deemph"], (B,))):
        _check(name, t, shape, f32, device)
    _check("last_exc", state["last_exc"], (B,), torch.int32, device)
    _check("rng", state["rng"], (B, 4), torch.int64, device)

    if T == 0:
        return ({k: v.clone() for k, v in state.items()},
                torch.empty((B, 0), dtype=f32, device=device))
    lib = _lib()
    logit_tbl = torch.stack([torch.as_tensor(SAMPLING_LOGIT_TABLE),
                             torch.as_tensor(ULAW2LIN_TABLE)]).to(device)
    new = {k: torch.empty_like(v) for k, v in state.items()}
    pcm = torch.empty((B, T * FRAME_SIZE), dtype=f32, device=device)
    p = _Params(
        ca_stride=T * 3 * NA, cb_stride=T * 3 * NB, lpc_stride=T * LPC_ORDER,
        tbl_sig=tables["tbl_sig"].data_ptr(),
        tbl_pred=tables["tbl_pred"].data_ptr(),
        tbl_exc=tables["tbl_exc"].data_ptr(),
        wr_a=tables["wr_a"].data_ptr(), br_a=tables["br_a"].data_ptr(),
        wi_b=tables["wi_b"].data_ptr(), wr_b=tables["wr_b"].data_ptr(),
        br_b=tables["br_b"].data_ptr(), dfc_w=dfc["w"].data_ptr(),
        dfc_b=dfc["b"].data_ptr(), dfc_f=dfc["factor"].data_ptr(),
        logit_tbl=logit_tbl.data_ptr(),
        gru_a_out=new["gru_a"].data_ptr(), gru_b_out=new["gru_b"].data_ptr(),
        sig_out=new["last_sig"].data_ptr(),
        exc_out=new["last_exc"].data_ptr(),
        deemph_out=new["deemph"].data_ptr(), rng_out=new["rng"].data_ptr(),
        pcm_stride=T * FRAME_SIZE, batch=B, preemph=cfg.preemph)
    stream = torch.cuda.current_stream(device).cuda_stream
    src = state
    with torch.cuda.device(device):
        for t in range(T):
            p.cond_a = conds["cond_a"].data_ptr() + 4 * t * 3 * NA
            p.cond_b = conds["cond_b"].data_ptr() + 4 * t * 3 * NB
            p.lpc = conds["lpc"].data_ptr() + 4 * t * LPC_ORDER
            p.pcm = pcm.data_ptr() + 4 * t * FRAME_SIZE
            p.gru_a_in = src["gru_a"].data_ptr()
            p.gru_b_in = src["gru_b"].data_ptr()
            p.sig_in = src["last_sig"].data_ptr()
            p.exc_in = src["last_exc"].data_ptr()
            p.deemph_in = src["deemph"].data_ptr()
            p.rng_in = src["rng"].data_ptr()
            err = lib.lpcnet_sample_frame(ctypes.byref(p), int(flat), stream)
            if err != 0:
                raise RuntimeError(
                    "sample_frame kernel launch failed: "
                    + lib.lpcnet_cuda_error_string(err).decode())
            launches[variant] += 1
            src = new
    return new, pcm


def synthesize_frame(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                     cond_a: torch.Tensor, cond_b: torch.Tensor,
                     lpc: torch.Tensor, cfg, variant: str = "flat"):
    """One frame: cond_a (B,3Na), cond_b (B,3Nb), lpc (B,16).
    Returns (new_state, pcm (B, 160))."""
    conds = {"cond_a": cond_a[:, None].contiguous(),
             "cond_b": cond_b[:, None].contiguous(),
             "lpc": lpc[:, None].contiguous()}
    return synthesize_frames(tables, state, conds, cfg, variant=variant)
