"""64-bit packet pack/unpack for the 1.6 kb/s codec (the port of
lpcnet_tpu/codec/packet.py).

Bit layout (MSB-first, lpcnet_enc.c:724-733):
  c0_id+64:7 | main_pitch:6 | modulation:3 | corr_id:2 |
  vq_end0:10 | vq_end1:10 | vq_end2:10 | vq_mid:13 | interp_id:3
Total 64 bits = 8 bytes = LPCNET_COMPRESSED_SIZE.
"""
from typing import Dict

import torch

FIELDS = (("c0", 7), ("main_pitch", 6), ("modulation", 3), ("corr_id", 2),
          ("vq_end0", 10), ("vq_end1", 10), ("vq_end2", 10),
          ("vq_mid", 13), ("interp_id", 3))
if sum(w for _, w in FIELDS) != 64:
    raise AssertionError("the packet fields must fill 64 bits")


def pack(fields: Dict[str, torch.Tensor]) -> torch.Tensor:
    """fields: dict of (...,) integer tensors -> (..., 8) uint8, MSB-first.
    Each field keeps its low `width` bits."""
    bits = []
    for name, width in FIELDS:
        v = fields[name].to(torch.int64)
        for b in range(width - 1, -1, -1):
            bits.append((v >> b) & 1)
    bits = torch.stack(bits, dim=-1)                    # (..., 64)
    bits = bits.reshape(bits.shape[:-1] + (8, 8))
    weights = 1 << torch.arange(7, -1, -1, device=bits.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def unpack(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., 8) uint8 -> dict of (...,) int32 fields."""
    b = buf.to(torch.int32)
    bits = torch.stack([(b >> k) & 1 for k in range(7, -1, -1)], dim=-1)
    bits = bits.reshape(bits.shape[:-2] + (64,))
    out = {}
    pos = 0
    for name, width in FIELDS:
        v = torch.zeros(bits.shape[:-1], dtype=torch.int32,
                        device=buf.device)
        for k in range(width):
            v = (v << 1) | bits[..., pos + k]
        out[name] = v
        pos += width
    return out
