"""The sample kernels (csrc/sample_frame.cu, csrc/sample_frame_opt.cu,
csrc/synth_samples.cu, csrc/teacher_advance.cu, every one an instance of
the sample loop of csrc/sample_loop.cuh) bound to PyTorch: the
counterparts of synthesize_frame(s)_pallas, synth_samples_pallas and
teacher_advance_pallas in lpcnet_tpu/kernels/sample_pallas.py.

For tensors on the CPU the functions run the plain PyTorch version
(kernels/sample_scan.py). For CUDA tensors they launch the kernel on the
current stream, or raise; there is no fallback. `launches[name]` counts
kernel launches (and nothing else), so a run can show that it went through
the kernels: 'flat' / 'base' for the free-run frame kernel with either
sampler, 'fuse' / 'opt' for the fused frame kernel, each with the suffix
'_bf16' for its instance on bfloat16 embedding tables (the JAX package's
table_dtype, sample_scan.bf16_tables), 'tf_flat' / 'tf_base' for
synth_samples, 'teacher' for teacher_advance. synth_samples and
teacher_advance take float32 tables only, as their TPU kernels do, and
raise on any other.

The sample loop has two launch plans, which launch_plan picks from the
batch and the card's count of co-resident 16-CTA clusters (max_clusters,
queried once per device; the least over every instance):
  'L' (B <= 8 x that count): a cluster of 16 CTAs per tile of 8 streams,
      GRU-A's columns split over the cluster, each CTA's wr_a slice (from
      plan_operands, built once per tables dict) in shared memory;
  'T' (larger B): one CTA per 8 streams in clusters of 2, wr_a streamed
      through a shared-memory ring by multicast bulk copies.
Both give the same bits. `plan_launches[plan]` counts the launches of
every kernel under each plan; `last_plan` is (plan, cluster size) of the
last one. A plan-L launch beyond the card's cluster count is refused by
the kernel's entry point and raises; nothing retries with the other plan.

The state dict layout is sample_scan's. The returned state is new memory.
"""
import contextlib
import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from ..constants import DUAL_FC_OUT, FRAME_SIZE, GRU_A_SIZE, GRU_B_SIZE, \
    LPC_ORDER
from ..ops.mulaw import ULAW2LIN_TABLE
from ..ops.tables import SAMPLING_LOGIT_TABLE, device_constant
from ..utils import graphs
from . import _build, sample_scan

VARIANTS = ("flat", "base")                      # synth_samples (K3)
# the frame kernel has the fused variants too: 'fuse' (one embedding table,
# one dual-FC product) and 'opt' (fuse with the thresholds drawn one sample
# ahead); all four give the same bits
FRAME_VARIANTS = VARIANTS + ("fuse", "opt")
# the widths the kernels are compiled for (csrc/lpcnet_sample.cuh)
NA, NB, NL = GRU_A_SIZE, GRU_B_SIZE, DUAL_FC_OUT

launches = {"flat": 0, "base": 0, "fuse": 0, "opt": 0, "flat_bf16": 0,
            "base_bf16": 0, "fuse_bf16": 0, "opt_bf16": 0, "tf_flat": 0,
            "tf_base": 0, "teacher": 0}

# the launch plans of the sample loop (csrc/sample_loop.cuh)
TILE = 8                    # streams per tile
CLUSTER_L, CLUSTER_T = 16, 2
UNITS_L = NA // CLUSTER_L   # GRU-A units per CTA of plan L
PLANS = {"L": 0, "T": 1}    # the entry points' plan codes
plan_launches = {"L": 0, "T": 0}
last_plan: Optional[Tuple[str, int]] = None
# the card's count of co-resident plan-L clusters per device index
# (max_clusters); _plan_forced overrides an entry
_max_clusters: Dict[int, int] = {}


def launch_plan(batch: int, max_clusters: int) -> Tuple[str, int, int, int]:
    """(plan, cluster size, streams per tile, grid in CTAs) of a launch of
    the sample loop over `batch` streams on a card that runs
    `max_clusters` 16-CTA clusters at once: plan L while every tile gets
    its own co-resident cluster, else plan T (the grid rounded up to whole
    clusters of 2; a CTA past the batch only shares wr_a)."""
    if batch <= 0:
        raise ValueError(f"batch must be positive, not {batch}")
    tiles = -(-batch // TILE)
    if tiles <= max_clusters:
        return "L", CLUSTER_L, TILE, tiles * CLUSTER_L
    return "T", CLUSTER_T, TILE, -(-tiles // CLUSTER_T) * CLUSTER_T


def plan_operands(tables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """wr_a repacked for plan L, built once per tables dict and kept in it
    under "plan_l": wr_a_l (16, 72, 384), where [r, g * 24 + u, k] =
    wr_a[k, g * 384 + 24 r + u], so each CTA's slice is one block. It is
    made of wr_a alone, which is float32 whatever the embedding tables'
    type, so a bf16 tables dict (sample_scan.bf16_tables) shares it."""
    if "plan_l" not in tables:
        wr_a = tables["wr_a"]
        tables["plan_l"] = {"wr_a_l": wr_a.reshape(
            NA, 3, CLUSTER_L, UNITS_L).permute(2, 1, 3, 0).reshape(
            CLUSTER_L, 3 * UNITS_L, NA).contiguous()}
    return tables["plan_l"]

_WEIGHTS = ("tbl_sig", "tbl_pred", "tbl_exc", "wr_a", "br_a", "wi_b", "wr_b",
            "br_b")
_STATE_PTRS = ("gru_a_in", "gru_b_in", "sig_in", "exc_in", "deemph_in",
               "rng_in", "gru_a_out", "gru_b_out", "sig_out", "exc_out",
               "deemph_out", "rng_out")


class _Params(ctypes.Structure):
    """ctypes twin of LpcnetFrameParams in csrc/lpcnet_sample.cuh."""
    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("cond_a", "cond_b", "lpc")]
        + [(n, ctypes.c_longlong)
           for n in ("ca_stride", "cb_stride", "lpc_stride")]
        + [(n, ctypes.c_void_p) for n in _WEIGHTS + (
            "dfc_w", "dfc_b", "dfc_f", "logit_tbl") + _STATE_PTRS + ("pcm",)]
        + [("pcm_stride", ctypes.c_longlong), ("target", ctypes.c_void_p),
           ("tgt_stride", ctypes.c_longlong), ("preload", ctypes.c_void_p),
           ("force_from", ctypes.c_void_p), ("n_active", ctypes.c_void_p),
           ("batch", ctypes.c_int), ("nsamples", ctypes.c_int),
           ("preemph", ctypes.c_float), ("wr_a_l", ctypes.c_void_p),
           ("prof", ctypes.c_void_p)])


_P, _I, _V = ctypes.POINTER, ctypes.c_int, ctypes.c_void_p
# the argument types of every entry point: a launch takes the argument
# block, (a variant switch, (the frame kernels) a bf16-table switch,) plan,
# grid, cluster count and stream
_LAUNCH = [_P(_Params), _I, _I, _I, _V]
_SWITCHED = _LAUNCH[:1] + [_I] + _LAUNCH[1:]
_FRAME = _LAUNCH[:1] + [_I, _I] + _LAUNCH[1:]
_PREPARE = {"lpcnet_prepare_plans": [_P(_I)]}
_ENTRIES = {
    "sample_frame": {"lpcnet_sample_frame": _FRAME,
                     "lpcnet_sample_phases": _LAUNCH, **_PREPARE},
    "synth_samples": {"lpcnet_synth_samples": _SWITCHED, **_PREPARE},
    "sample_frame_opt": {"lpcnet_sample_frame_opt": _FRAME, **_PREPARE},
    "teacher_advance": {"lpcnet_teacher_advance": _LAUNCH,
                        "lpcnet_teacher_phases": _LAUNCH, **_PREPARE},
}
LIBRARIES = tuple(_ENTRIES)


def _lib(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu with its entry points typed."""
    lib = _build.load(name)
    if not getattr(lib, "_lpcnet_typed", False):
        for fn, argtypes in _ENTRIES[name].items():
            entry = getattr(lib, fn)
            entry.argtypes, entry.restype = argtypes, ctypes.c_int
        lib.lpcnet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.lpcnet_cuda_error_string.restype = ctypes.c_char_p
        lib._lpcnet_typed = True
    return lib


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.lpcnet_cuda_error_string(err).decode())


_logit_tbls: Dict[torch.device, torch.Tensor] = {}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def max_clusters(device: torch.device) -> int:
    """How many 16-CTA clusters of plan L the card runs at once: the least
    cudaOccupancyMaxActiveClusters over every instance of the sample loop
    in every library (their register counts differ). The first call on a
    device builds the libraries that are not built yet, together, and
    readies every kernel there (lpcnet_prepare_plans), which every launch
    needs. Raises if a query fails or gives 0."""
    index = _index(device)
    if index not in _max_clusters:
        _build.build(LIBRARIES)
        n = ctypes.c_int(2 ** 31 - 1)
        with torch.cuda.device(index):
            for name in LIBRARIES:
                lib = _lib(name)
                _raise_on(lib.lpcnet_prepare_plans(ctypes.byref(n)), lib,
                          "cluster occupancy query")
        if n.value <= 0:
            raise RuntimeError("the card runs no 16-CTA cluster of plan L")
        _max_clusters[index] = n.value
    return _max_clusters[index]


@contextlib.contextmanager
def _plan_forced(device: torch.device, plan: str):
    """For the card tests and chip_smoke.py: every kernel launch inside
    takes `plan`, through launch_plan's input, the cluster count (the
    card's own for L, 0 for T). The entry points run eagerly inside
    (graphs.disabled()): a graph captured under another plan would replay
    it."""
    index, real = _index(device), max_clusters(device)
    _max_clusters[index] = real if plan == "L" else 0
    try:
        with graphs.disabled():
            yield
    finally:
        _max_clusters[index] = real


def _plan(batch: int, device: torch.device) -> Tuple[str, int, int]:
    """(plan, grid, cluster count) of launch_plan for this batch on this
    card, recorded as the last."""
    global last_plan
    clusters = max_clusters(device)
    plan, cluster, _, grid = launch_plan(batch, clusters)
    last_plan = (plan, cluster)
    return plan, grid, clusters


def _logit_tbl(device: torch.device) -> torch.Tensor:
    """(2, 256) SAMPLING_LOGIT_TABLE and ULAW2LIN_TABLE, one copy kept on
    each device."""
    if device not in _logit_tbls:
        _logit_tbls[device] = torch.stack(
            [device_constant(SAMPLING_LOGIT_TABLE, device),
             device_constant(ULAW2LIN_TABLE, device)])
    return _logit_tbls[device]


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
        raise ValueError("the CUDA sample kernels are compiled for GRU-A "
                         "384, GRU-B 16, 256 levels and 160-sample frames")
    if cfg.approx:
        raise ValueError("the CUDA sample kernels compute exact "
                         "activations; cfg.approx needs the CPU path")


_WEIGHT_SHAPES = ((NL, 3 * NA),) * 3 + (
    (NA, 3 * NA), (3 * NA,), (NA, 3 * NB), (NB, 3 * NB), (3 * NB,))


def _check_weights(tables, device, dual_fc=True, table_dtype=torch.float32):
    """table_dtype: the type of the three embedding tables; every other
    weight is float32."""
    f32 = torch.float32
    for name, shape in zip(_WEIGHTS, _WEIGHT_SHAPES):
        _check(name, tables[name], shape,
               table_dtype if name in sample_scan.TABLES else f32, device)
    if dual_fc:
        dfc = tables["dual_fc"]
        _check("dual_fc.w", dfc["w"], (2, NB, NL), f32, device)
        _check("dual_fc.b", dfc["b"], (2, NL), f32, device)
        _check("dual_fc.factor", dfc["factor"], (2, NL), f32, device)


def _check_state(state, batch: int, device):
    f32 = torch.float32
    _check("gru_a", state["gru_a"], (batch, NA), f32, device)
    _check("gru_b", state["gru_b"], (batch, NB), f32, device)
    _check("last_sig", state["last_sig"], (batch, LPC_ORDER), f32, device)
    _check("deemph", state["deemph"], (batch,), f32, device)
    _check("last_exc", state["last_exc"], (batch,), torch.int32, device)
    _check("rng", state["rng"], (batch, 4), torch.int64, device)


def _state_ptrs(state, new) -> Dict[str, int]:
    """The state pointers of an argument block: in from state, out to new."""
    leaves = (("gru_a", "gru_a"), ("gru_b", "gru_b"), ("sig", "last_sig"),
              ("exc", "last_exc"), ("deemph", "deemph"), ("rng", "rng"))
    ptrs = {f"{f}_in": state[k].data_ptr() for f, k in leaves}
    ptrs.update({f"{f}_out": new[k].data_ptr() for f, k in leaves})
    return ptrs


def _sample_params(tables, state, new, pcm, batch, nsamples, cfg,
                   cond=None) -> _Params:
    """The argument block of the sample loop; pcm None: no output rows and
    no dual-FC (K4). cond: one condition set (B, *), else the caller sets
    the condition pointers."""
    wr_a_l = plan_operands(tables)["wr_a_l"]
    _check("wr_a_l", wr_a_l, (CLUSTER_L, 3 * UNITS_L, NA), torch.float32,
           tables["wr_a"].device)
    for name, t in (("wr_a", tables["wr_a"]), ("wr_a_l", wr_a_l)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    p = _Params(
        **{k: tables[k].data_ptr() for k in _WEIGHTS},
        wr_a_l=wr_a_l.data_ptr(), **_state_ptrs(state, new), batch=batch,
        nsamples=nsamples, preemph=cfg.preemph)
    if pcm is not None:
        dfc = tables["dual_fc"]
        p.dfc_w, p.dfc_b = dfc["w"].data_ptr(), dfc["b"].data_ptr()
        p.dfc_f = dfc["factor"].data_ptr()
        p.logit_tbl = _logit_tbl(pcm.device).data_ptr()
        p.pcm, p.pcm_stride = pcm.data_ptr(), pcm.stride(0)
    if cond is not None:
        p.cond_a, p.ca_stride = cond["cond_a"].data_ptr(), 3 * NA
        p.cond_b, p.cb_stride = cond["cond_b"].data_ptr(), 3 * NB
        p.lpc, p.lpc_stride = cond["lpc"].data_ptr(), LPC_ORDER
    return p


def _fuse_operands(p: _Params, tables, device) -> None:
    """Points an argument block at the fused frame kernel's operands, built
    once per tables dict (sample_scan.fused_operands): the three table
    pointers at rows 0, NL and 2 * NL of tbl_cat, dfc_w at dfc_w12 (NB,
    2 * NL) and dfc_b at dfc_b12 (2 * NL), which has dfc_b's layout."""
    fused = sample_scan.fused_operands(tables)
    f32 = torch.float32
    _check("tbl_cat", fused["tbl_cat"], (3 * NL, 3 * NA),
           sample_scan.table_dtype(tables), device)
    _check("dfc_w12", fused["dfc_w12"], (NB, 2 * NL), f32, device)
    _check("dfc_b12", fused["dfc_b12"], (2 * NL,), f32, device)
    rows = fused["tbl_cat"].data_ptr()
    table = NL * 3 * NA * fused["tbl_cat"].element_size()
    p.tbl_sig, p.tbl_pred, p.tbl_exc = rows, rows + table, rows + 2 * table
    p.dfc_w = fused["dfc_w12"].data_ptr()
    p.dfc_b = fused["dfc_b12"].data_ptr()


def _require_f32_tables(tables, what: str) -> None:
    """K3 and K4 take float32 embedding tables only, as synth_samples_pallas
    and teacher_advance_pallas do (no table_dtype): anything else raises,
    on every device, and is never cast."""
    if sample_scan.table_dtype(tables) != torch.float32:
        raise TypeError(f"{what} takes float32 embedding tables only; "
                        f"bfloat16 tables are for the frame kernels")


def _variant_flat(variant: str) -> bool:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, not {variant!r}")
    return variant == "flat"


def synthesize_frames(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                      conds: Dict[str, torch.Tensor], cfg,
                      variant: str = "flat"
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Free-run synthesis of T frames for B streams, one launch per frame.

    conds: cond_a (B,T,3Na), cond_b (B,T,3Nb), lpc (B,T,16). variant: 'flat'
    (flat sampling tree, K1), 'base' (walked tree, K2), 'fuse' or 'opt' (the
    fused frame kernel K5, without and with the thresholds drawn one sample
    ahead); all give the same bits. The three embedding tables are float32,
    or bfloat16 (sample_scan.bf16_tables) for the kernels' bf16 instances,
    which give the bits of the float32 kernel on those tables widened.
    Returns (new_state, pcm (B, T*160) float32)."""
    if variant not in FRAME_VARIANTS:
        raise ValueError(f"variant must be one of {FRAME_VARIANTS}, not "
                         f"{variant!r}")
    fused = variant in ("fuse", "opt")
    tdtype = sample_scan.table_dtype(tables)
    device = conds["cond_a"].device
    if device.type == "cpu":
        if fused:
            return sample_scan.synthesize_frames_opt(
                tables, state, conds, cfg, pipeline_thr=variant == "opt")
        return sample_scan.synthesize_frames(tables, state, conds, cfg,
                                             flat=variant == "flat")
    if device.type != "cuda":
        raise ValueError(f"no frame kernel for device {device}")
    _check_cfg(cfg)
    B, T = conds["cond_a"].shape[:2]
    f32 = torch.float32
    _check("cond_a", conds["cond_a"], (B, T, 3 * NA), f32, device)
    _check("cond_b", conds["cond_b"], (B, T, 3 * NB), f32, device)
    _check("lpc", conds["lpc"], (B, T, LPC_ORDER), f32, device)
    _check_weights(tables, device, table_dtype=tdtype)
    _check_state(state, B, device)
    bf16 = tdtype == torch.bfloat16
    counter = variant + "_bf16" if bf16 else variant

    if T == 0:
        return ({k: v.clone() for k, v in state.items()},
                torch.empty((B, 0), dtype=f32, device=device))
    new = {k: torch.empty_like(v) for k, v in state.items()}
    pcm = torch.empty((B, T * FRAME_SIZE), dtype=f32, device=device)
    p = _sample_params(tables, state, new, pcm, B, FRAME_SIZE, cfg)
    if fused:
        lib = _lib("sample_frame_opt")
        launch, switch = lib.lpcnet_sample_frame_opt, variant == "opt"
        _fuse_operands(p, tables, device)
    else:
        lib = _lib("sample_frame")
        launch, switch = lib.lpcnet_sample_frame, variant == "flat"
    plan, grid, clusters = _plan(B, device)
    p.ca_stride, p.cb_stride = T * 3 * NA, T * 3 * NB
    p.lpc_stride = T * LPC_ORDER
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        for t in range(T):
            p.cond_a = conds["cond_a"].data_ptr() + 4 * t * 3 * NA
            p.cond_b = conds["cond_b"].data_ptr() + 4 * t * 3 * NB
            p.lpc = conds["lpc"].data_ptr() + 4 * t * LPC_ORDER
            p.pcm = pcm.data_ptr() + 4 * t * FRAME_SIZE
            _raise_on(launch(ctypes.byref(p), int(switch), int(bf16),
                             PLANS[plan], grid, clusters, stream), lib,
                      f"sample_frame ({counter})")
            launches[counter] += 1
            plan_launches[plan] += 1
            # later frames update the new state in place
            p.gru_a_in, p.gru_b_in = p.gru_a_out, p.gru_b_out
            p.sig_in, p.exc_in = p.sig_out, p.exc_out
            p.deemph_in, p.rng_in = p.deemph_out, p.rng_out
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


PHASES = ("A", "gru_a_loop", "gru_a_epilogue", "exchange", "gru_b",
          "dual_fc", "sampler", "H")


def phase_split(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                cond: Dict[str, torch.Tensor], cfg,
                target: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """One launch through the instance that stamps the SM clock around
    each phase of the step on the first CTA, under the plan launch_plan
    picks: the free-run frame (flat sampler), or with a target (B, ns) the
    teacher advance (K4: its dual_fc and sampler phases are empty). Returns
    us per step for each of PHASES, the whole step, the SM clock, the plan.
    Counted in neither `launches` nor `plan_launches`: a measurement, never
    the main path."""
    device = cond["cond_a"].device
    B = cond["cond_a"].shape[0]
    _check_cfg(cfg)
    _check_cond(cond, B, device)
    _check_weights(tables, device, dual_fc=target is None)
    _check_state(state, B, device)
    clusters = max_clusters(device)
    plan, cluster, _, grid = launch_plan(B, clusters)
    new = {k: torch.empty_like(v) for k, v in state.items()}
    if target is None:
        lib = _lib("sample_frame")
        entry = lib.lpcnet_sample_phases
        pcm = torch.empty((B, FRAME_SIZE), dtype=torch.float32,
                          device=device)
        p = _sample_params(tables, state, new, pcm, B, FRAME_SIZE, cfg, cond)
    else:
        lib = _lib("teacher_advance")
        entry = lib.lpcnet_teacher_phases
        _check("target", target, (B, target.shape[-1]), torch.float32,
               device)
        p = _sample_params(tables, state, new, None, B, target.shape[1],
                           cfg, cond)
        p.target, p.tgt_stride = target.data_ptr(), target.shape[1]
    prof = torch.zeros(len(PHASES) + 3, dtype=torch.int64, device=device)
    p.prof = prof.data_ptr()
    with torch.cuda.device(device):
        _raise_on(entry(ctypes.byref(p), PLANS[plan], grid, clusters,
                        torch.cuda.current_stream(device).cuda_stream), lib,
                  "phase split")
    c = prof.cpu().tolist()
    cycles, ns, steps = c[len(PHASES):]
    out: Dict[str, Any] = {k: c[q] * ns / cycles / 1e3 / steps
                           for q, k in enumerate(PHASES)}
    out.update(step=ns / 1e3 / steps, clock_ghz=cycles / ns, plan=plan,
               cluster=cluster)
    return out


def _check_cond(cond, batch: int, device):
    f32 = torch.float32
    _check("cond_a", cond["cond_a"], (batch, 3 * NA), f32, device)
    _check("cond_b", cond["cond_b"], (batch, 3 * NB), f32, device)
    _check("lpc", cond["lpc"], (batch, LPC_ORDER), f32, device)


def synth_samples(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                  cond: Dict[str, torch.Tensor], cfg, nsamples: int,
                  target: Optional[torch.Tensor] = None,
                  preload: Optional[torch.Tensor] = None,
                  n_active: Optional[torch.Tensor] = None,
                  force_from: Optional[torch.Tensor] = None,
                  variant: str = "flat"
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`nsamples` steps under one condition set with optional teacher
    forcing and per-stream active counts, in one launch (K3); the
    arguments are sample_scan.synth_samples's.

    cond: cond_a (B,3Na), cond_b (B,3Nb), lpc (B,16); target (B, nsamples)
    float32; preload, n_active, force_from (B,) int32.
    Returns (new_state, (B, nsamples) float32)."""
    flat = _variant_flat(variant)
    _require_f32_tables(tables, "synth_samples")
    device = cond["cond_a"].device
    if device.type == "cpu":
        return sample_scan.synth_samples(
            tables, state, cond, cfg, nsamples, target=target,
            preload=preload, n_active=n_active, force_from=force_from,
            flat=flat)
    if device.type != "cuda":
        raise ValueError(f"no sample kernel for device {device}")
    _check_cfg(cfg)
    if nsamples <= 0:
        raise ValueError(f"nsamples must be positive, not {nsamples}")
    B = cond["cond_a"].shape[0]
    _check_cond(cond, B, device)
    _check_weights(tables, device)
    _check_state(state, B, device)
    i32 = torch.int32
    if target is None:
        if preload is not None or force_from is not None:
            raise ValueError("preload and force_from need a target")
    else:
        _check("target", target, (B, nsamples), torch.float32, device)
        # the defaults of sample_scan.synth_samples, as tensors
        if preload is None:
            preload = torch.full((B,), 0 if force_from is not None
                                 else nsamples, dtype=i32, device=device)
        if force_from is None:
            force_from = torch.full((B,), nsamples, dtype=i32, device=device)
    for name, t in (("preload", preload), ("n_active", n_active),
                    ("force_from", force_from)):
        if t is not None:
            _check(name, t, (B,), i32, device)

    lib = _lib("synth_samples")
    plan, grid, clusters = _plan(B, device)
    new = {k: torch.empty_like(v) for k, v in state.items()}
    pcm = torch.empty((B, nsamples), dtype=torch.float32, device=device)
    p = _sample_params(tables, state, new, pcm, B, nsamples, cfg, cond)
    if target is not None:
        p.target, p.tgt_stride = target.data_ptr(), nsamples
        p.preload, p.force_from = preload.data_ptr(), force_from.data_ptr()
    if n_active is not None:
        p.n_active = n_active.data_ptr()
    with torch.cuda.device(device):
        _raise_on(lib.lpcnet_synth_samples(
            ctypes.byref(p), int(flat), PLANS[plan], grid, clusters,
            torch.cuda.current_stream(device).cuda_stream),
            lib, "synth_samples")
    launches["tf_" + variant] += 1
    plan_launches[plan] += 1
    return new, pcm


def teacher_advance(tables: Dict[str, Any], state: Dict[str, torch.Tensor],
                    cond: Dict[str, torch.Tensor], cfg, target: torch.Tensor
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """State advance over a fully teacher-forced segment in one launch
    (K4): the arguments and the result of sample_scan.teacher_advance, which
    runs instead for tensors on the CPU. The kernel computes the table
    indices, the non-GRU state and the RNG advance in its loop.

    cond: cond_a (B,3Na), cond_b (B,3Nb), lpc (B,16); target (B, ns)
    float32. Returns (new_state, target)."""
    _require_f32_tables(tables, "teacher_advance")
    device = cond["cond_a"].device
    if device.type == "cpu":
        return sample_scan.teacher_advance(tables, state, cond, cfg, target)
    if device.type != "cuda":
        raise ValueError(f"no teacher-advance kernel for device {device}")
    _check_cfg(cfg)
    B = cond["cond_a"].shape[0]
    if target.dim() != 2 or target.shape[1] == 0:
        raise ValueError("target must be (B, ns) with ns > 0, not "
                         f"{tuple(target.shape)}")
    ns = target.shape[1]
    _check_cond(cond, B, device)
    _check("target", target, (B, ns), torch.float32, device)
    _check_weights(tables, device, dual_fc=False)
    _check_state(state, B, device)

    lib = _lib("teacher_advance")
    plan, grid, clusters = _plan(B, device)
    new = {k: torch.empty_like(v) for k, v in state.items()}
    p = _sample_params(tables, state, new, None, B, ns, cfg, cond)
    p.target, p.tgt_stride = target.data_ptr(), ns
    with torch.cuda.device(device):
        _raise_on(lib.lpcnet_teacher_advance(
            ctypes.byref(p), PLANS[plan], grid, clusters,
            torch.cuda.current_stream(device).cuda_stream),
            lib, "teacher_advance")
    launches["teacher"] += 1
    plan_launches[plan] += 1
    return new, target
