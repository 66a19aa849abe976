"""High-level synthesis API (the port of lpcnet_tpu/vocoder.py, reference
include/lpcnet.h:163-198).

State is an explicit dict (state in, state out), so streams are batched:

    voc = Synthesizer()                     # shipped weights, on the card
    state = voc.reset(batch=256)
    state, pcm = voc.synthesize(state, features)   # (B, T, 36) -> (B, T*160)

On a CUDA device every frame runs the hand-written frame kernel
(kernels/sample_cuda.py); device="cpu" runs the plain PyTorch loop.
"""
from typing import Any, Dict, Optional, Tuple

import torch

from . import convert
from .device import resolve_device
from .kernels import sample_cuda, sample_scan
from .models import lpcnet
from .ops import kiss99


class Synthesizer:
    def __init__(self, cfg: Optional[lpcnet.LPCNetConfig] = None,
                 params: Optional[Dict[str, Any]] = None, device=None,
                 variant: str = "flat"):
        """params: the port's parameter dict (convert.load_lpcnet /
        params_from_numpy); None loads the shipped checkpoint. device: None
        means the card, and raises where there is none. variant: 'flat'
        (flat sampling tree) or 'base' (walked tree); same bits."""
        self.device = resolve_device(device)
        if variant not in sample_cuda.VARIANTS:
            raise ValueError(f"variant must be one of {sample_cuda.VARIANTS}")
        self.cfg = cfg or lpcnet.LPCNetConfig()
        if params is None:
            params = convert.load_lpcnet(device=self.device)
        self.params = _to(params, self.device)
        self.tables = lpcnet.precompute_sample_tables(self.params, self.cfg)
        self.variant = variant

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
        return sample_cuda.synthesize_frames(self.tables, state, conds,
                                             self.cfg, variant=self.variant)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32).contiguous()
