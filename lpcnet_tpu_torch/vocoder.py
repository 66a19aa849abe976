"""High-level synthesis API (the port of lpcnet_tpu/vocoder.py, reference
include/lpcnet.h:163-198).

State is an explicit dict (state in, state out), so streams are batched:

    voc = Synthesizer()                     # shipped weights, on the card
    state = voc.reset(batch=256)
    state, pcm = voc.synthesize(state, features)   # (B, T, 36) -> (B, T*160)

On a CUDA device every frame of synthesize runs the hand-written frame
kernel and every frame of synthesize_teacher / synthesize_streaming one
synth_samples launch (kernels/sample_cuda.py); device="cpu" runs the plain
PyTorch loops. synthesize_temperature runs the plain loop on either device.
Synthesizer(backend="dotprod") runs synthesize and synthesize_streaming
through the emulation of the reference's int8 DOT_PROD arithmetic
(kernels/sample_dotprod.py, plain PyTorch) on either device.
Synthesizer(tables="bf16") gives synthesize's frame kernel bfloat16
embedding tables (the JAX package's LPCNET_KERNEL_TABLES=bf16); every other
mode keeps float32 tables, as in the JAX package.
"""
from typing import Any, Dict, Optional, Tuple

import torch

from . import convert
from .device import resolve_device
from .kernels import sample_cuda, sample_dotprod, sample_scan
from .models import lpcnet
from .ops import kiss99

TABLE_TYPES = ("f32", "bf16")
BACKENDS = ("auto", "dotprod")


class Synthesizer:
    def __init__(self, cfg: Optional[lpcnet.LPCNetConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None,
                 variant: str = "flat", tables: str = "f32",
                 backend: str = "auto", dotprod_su: bool = False):
        """params: the port's parameter dict (convert.load_lpcnet /
        params_from_numpy); None loads the shipped checkpoint. device: None
        means the card, and raises where there is none. variant: the frame
        kernel of synthesize: 'flat' (flat sampling tree), 'base' (walked
        tree), 'fuse' (one embedding table and one dual-FC product) or
        'opt' (fuse with the thresholds drawn one sample ahead); same bits.
        The JAX package reads it from LPCNET_KERNEL_VARIANT. tables: the
        type of synthesize's embedding tables, 'f32' or 'bf16' (a copy
        rounded to nearest even, made once; the JAX package reads it from
        LPCNET_KERNEL_TABLES). bf16 tables are a reduced-precision model:
        other bits than f32, the same in every variant. On the CPU
        synthesize runs the plain loop on the rounded tables widened.
        backend: 'auto' (the hand-written kernels on the card, the plain
        loops on the CPU) or 'dotprod' (synthesize and synthesize_streaming
        emulate the reference's int8 DOT_PROD arithmetic exactly, in plain
        PyTorch on the synthesizer's device; float32 tables; teacher and
        temperature synthesis are the same as under 'auto', as in the JAX
        package). dotprod_su: the unsigned+SU-bias AVX/NEON flavour of
        dotprod instead of the signed portable one."""
        self.device = resolve_device(device)
        if variant not in sample_cuda.FRAME_VARIANTS:
            raise ValueError(
                f"variant must be one of {sample_cuda.FRAME_VARIANTS}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, not "
                             f"{backend!r}")
        if backend == "dotprod" and tables != "f32":
            raise ValueError("the dotprod backend takes float32 tables")
        if dotprod_su and backend != "dotprod":
            raise ValueError("dotprod_su is a flavour of backend='dotprod'")
        self.cfg = cfg or lpcnet.LPCNetConfig()
        if params is None:
            params = convert.load_lpcnet(device=self.device)
        self.params = convert.to_device(params, self.device)
        if tables not in TABLE_TYPES:
            raise ValueError(f"tables must be one of {TABLE_TYPES}, not "
                             f"{tables!r}")
        self.tables = lpcnet.precompute_sample_tables(self.params, self.cfg)
        # the frame kernel's operand: the tables, or a bf16 copy of the
        # three embedding tables
        self.frame_tables = (sample_scan.bf16_tables(self.tables)
                             if tables == "bf16" else self.tables)
        self.variant = variant
        # synth_samples has the two samplers only; as in the JAX package
        # anything but 'flat' maps to the walked tree
        self.tf_variant = "flat" if variant == "flat" else "base"
        self.backend = backend
        if backend == "dotprod":
            self.qtables = sample_dotprod.quantize_tables(
                self.tables, self.cfg, su_bias=dotprod_su)

    def reset(self, batch: int, per_stream_rng: bool = False):
        """Fresh per-stream state (lpcnet_reset, lpcnet.c:174-182)."""
        seeds = kiss99.batched_seed(batch, per_stream=per_stream_rng)
        return sample_scan.init_state(batch, self.cfg, seeds, self.device)

    def conditions(self, features) -> Dict[str, torch.Tensor]:
        """features (B, T, >=20) -> cond_a, cond_b, lpc, cfeat."""
        f = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)
        return lpcnet.frame_conditions(self.params, f, self.cfg, self.tables)

    @torch.no_grad()
    def synthesize(self, state, features
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """features: (B, T, 20..36) -> (new_state, pcm (B, T*160) float32
        of rounded int16-range samples)."""
        conds = self.conditions(features)
        if self.backend == "dotprod":
            return sample_dotprod.synthesize_frames_dotprod(
                self.tables, self.qtables, state, conds, self.cfg)
        return sample_cuda.synthesize_frames(self.frame_tables, state, conds,
                                             self.cfg, variant=self.variant)

    @torch.no_grad()
    def synthesize_teacher(self, state, features, target, preload):
        """Teacher-forced synthesis (the C 'preload' mode, lpcnet.c:256-261):
        per frame, samples [0, preload[b, t]) follow `target` (B, T*160)
        instead of the sampled excitation; preload (B, T) int. One
        synth_samples call per frame. Returns (new_state, pcm (B, T*160))."""
        conds = self.conditions(features)
        target = torch.as_tensor(target, dtype=torch.float32,
                                 device=self.device)
        preload = torch.as_tensor(preload, dtype=torch.int32,
                                  device=self.device)
        fs = self.cfg.frame_size
        B, T = conds["cond_a"].shape[:2]
        if target.shape != (B, T * fs) or preload.shape != (B, T):
            raise ValueError(
                f"target must be {(B, T * fs)} and preload {(B, T)}, not "
                f"{tuple(target.shape)} and {tuple(preload.shape)}")
        pcm = []
        for t in range(T):
            cond = {k: conds[k][:, t].contiguous()
                    for k in ("cond_a", "cond_b", "lpc")}
            state, out = sample_cuda.synth_samples(
                self.tables, state, cond, self.cfg, fs,
                target=target[:, t * fs:(t + 1) * fs].contiguous(),
                preload=preload[:, t].contiguous(), variant=self.tf_variant)
            pcm.append(out)
        return state, torch.cat(pcm, dim=1) if pcm else target

    @torch.no_grad()
    def synthesize_temperature(self, state, features):
        """Temperature/PDF-floor sampling (training_tf2/test_lpcnet.py:
        131-138): voiced frames are sharpened with p *= p^max(0,
        1.5*corr_feat - 0.5) and the pdf tail below 0.002 is cut: less
        noisy voiced segments at the price of leaving the C-bit-exact
        sampling path. It runs the plain PyTorch loop on the synthesizer's
        device, the card included: the JAX package has no kernel for this
        mode either (its scan backend only)."""
        f = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)
        conds = self.conditions(f)
        texp = torch.clamp(1.5 * f[..., 19] - 0.5, min=0.0)
        return sample_scan.synthesize_frames(self.tables, state, conds,
                                             self.cfg, temp_exp=texp)

    # ------------------------------------------------ reference-exact mode
    def reset_streaming(self, batch: int, per_stream_rng: bool = False):
        """State for synthesize_streaming: the sample state and the causal
        frame network's delay lines (conv memories, FEATURES_DELAY LPC)."""
        return {"synth": self.reset(batch, per_stream_rng),
                "fnet": lpcnet.frame_net_init_state(batch, self.cfg,
                                                    self.device)}

    @torch.no_grad()
    def synthesize_streaming(self, state, features):
        """Sample-exact twin of the C engine (lpcnet_synthesize,
        lpcnet.c:279-281): causal convs with warm-up zeroing, FEATURES_DELAY
        LPC pipelining, and the first FEATURES_DELAY frames emitted as
        silence WITHOUT advancing the sample network or the RNG
        (lpcnet_synthesize_tail_impl, lpcnet.c:239-243). Per frame: one
        frame_net_step and one free-run synth_samples call of 160 samples
        (under backend='dotprod', 160 quantized steps).
        The batched `synthesize` uses same-padded convs, whose conditioning
        alignment differs from the C's causal delay line.
        features (B, T, >=20). Returns (new_state, pcm (B, T*160))."""
        f = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)
        cfg = self.cfg
        fnet, synth = state["fnet"], state["synth"]
        pcm = []
        for t in range(f.shape[1]):
            fnet, cond = lpcnet.frame_net_step(self.params, self.tables,
                                               fnet, f[:, t], cfg)
            cond = {k: cond[k].contiguous() for k in ("cond_a", "cond_b",
                                                      "lpc")}
            if self.backend == "dotprod":
                new_synth, out = sample_dotprod.synth_samples_dotprod(
                    self.tables, self.qtables, synth, cond, cfg,
                    cfg.frame_size)
            else:
                new_synth, out = sample_cuda.synth_samples(
                    self.tables, synth, cond, cfg, cfg.frame_size,
                    variant=self.tf_variant)
            warm = fnet["frame_count"] > cfg.lookahead           # (B,)
            synth = {k: torch.where(
                warm.reshape((-1,) + (1,) * (v.dim() - 1)), v, synth[k])
                for k, v in new_synth.items()}
            pcm.append(torch.where(warm[:, None], out, 0.0))
        out = torch.cat(pcm, dim=1) if pcm else f.new_zeros((f.shape[0], 0))
        return {"synth": synth, "fnet": fnet}, out
