"""1.6 kb/s codec: superframe encode and decode, 8 bytes per 40 ms (the
port of lpcnet_tpu/codec/codec.py).

Encoder = the quantize branch of process_superframe (lpcnet_enc.c:702-737);
decoder = decode_packet (lpcnet_dec.c:81-155). Both are batched over
streams; the searches are the distance products of vq.py.

Codebooks are parameters: the commands read the trained set shipped as
examples/codec_codebooks.bin (utils/weights_io.load_params); the reference
generates ceps_codebooks.c with its offline trainer src/ceps_vq_train.c.
"""
from typing import Dict, List, Sequence, Union

import torch

from ..constants import NB_BANDS, NB_TOTAL_FEATURES
from ..features import quantized_pitch
from ..ops import dsp
from . import packet, vq

Codebooks = Dict[str, torch.Tensor]


def default_codebooks(generator: torch.Generator, device=None) -> Codebooks:
    """Placeholder codebooks drawn from `generator`, at the scale of the
    cepstral range. Their draws are not the JAX package's placeholders'
    (jax.random and torch give different numbers from one seed), so
    packets made with them match only the port's own. Real deployments use
    trained codebooks (examples/codec_codebooks.bin)."""
    def draw(scale, shape):
        return (scale * torch.randn(shape, generator=generator)).to(device)
    return {"cb1": draw(1.0, (1024, NB_BANDS - 1)),
            "cb2": draw(0.3, (1024, NB_BANDS - 1)),
            "cb3": draw(0.15, (1024, NB_BANDS - 1)),
            "diff4": draw(0.5, (4096, NB_BANDS))}


def _quantize_frame3(codebooks: Codebooks, f: torch.Tensor):
    """The vq_mem-independent half of the superframe encode: c0 scalar
    quantization (lpcnet_enc.c:704-706) and the 3-stage M-best VQ of frame
    3's cepstrum tail (:707). f: (N, 4, 36). Returns (f updated, a copy;
    c0_id (N,) int32; entries (N, 3))."""
    c0_id = torch.clamp(torch.floor(0.5 + f[:, 3, 0] * 4.0), -64, 63
                        ).to(torch.int32)
    f = f.clone()
    f[:, 3, 0] = c0_id.to(torch.float32) / 4.0
    entries, recon = vq.quantize_3stage_mbest(
        f[:, 3, 1:NB_BANDS], codebooks["cb1"], codebooks["cb2"],
        codebooks["cb3"])
    f[:, 3, 1:NB_BANDS] = recon
    return f, c0_id, entries


def _finish_encode(codebooks: Codebooks, f: torch.Tensor,
                   vq_mem: torch.Tensor, sp: Dict[str, torch.Tensor],
                   c0_id: torch.Tensor, entries: torch.Tensor):
    """The vq_mem-dependent half: predictive diff VQ of frame 1
    (lpcnet_enc.c:709), double interpolation of frames 0 and 2
    (:710-711), LPC refresh (:714-717), bit packing (:724-733). All
    (N, ...). Returns (packets (N, 8) uint8, quantized f, f[:, 3, :18])."""
    vq_mid, recon1 = vq.quantize_diff(
        f[:, 1, :NB_BANDS], vq_mem, f[:, 3, :NB_BANDS], codebooks["diff4"],
        bits=12, sign=True)
    f = f.clone()
    f[:, 1, :NB_BANDS] = recon1
    interp_id = vq.double_interp_search(
        f[:, 0, :NB_BANDS], f[:, 1, :NB_BANDS], f[:, 2, :NB_BANDS],
        f[:, 3, :NB_BANDS], vq_mem)
    nf0, nf2 = vq.perform_double_interp(
        f[:, 0, :NB_BANDS], f[:, 1, :NB_BANDS], f[:, 2, :NB_BANDS],
        f[:, 3, :NB_BANDS], vq_mem, interp_id)
    f[:, 0, :NB_BANDS] = nf0
    f[:, 2, :NB_BANDS] = nf2
    lpc, _ = dsp.lpc_from_cepstrum(f[..., :NB_BANDS])
    f[..., NB_BANDS + 2:] = lpc
    fields = {
        "c0": c0_id + 64,
        "main_pitch": sp["main_pitch"],
        "modulation": torch.where(sp["voiced"], sp["modulation"] + 4, 0),
        "corr_id": sp["corr_id"],
        "vq_end0": entries[..., 0], "vq_end1": entries[..., 1],
        "vq_end2": entries[..., 2],
        "vq_mid": vq_mid, "interp_id": interp_id,
    }
    return packet.pack(fields), f, f[:, 3, :NB_BANDS]


def encode_superframe(codebooks: Codebooks, feats: torch.Tensor,
                      vq_mem: torch.Tensor, sp: Dict[str, torch.Tensor]):
    """Quantize one superframe and pack its packet.

    feats: (B, 4, 36) features computed with quantize_pitch=True; vq_mem:
    (B, 18) the previous superframe's quantized frame-3 cepstrum; sp: the
    superframe's pitch dict from features.compute_features.
    Returns (packets (B, 8) uint8, quantized feats (B, 4, 36), new
    vq_mem)."""
    f, c0_id, entries = _quantize_frame3(codebooks, feats)
    return _finish_encode(codebooks, f, vq_mem, sp, c0_id, entries)


def encode_superframes(codebooks: Codebooks, feats: torch.Tensor,
                       vq_mem: torch.Tensor,
                       sps: Union[Sequence[Dict[str, torch.Tensor]],
                                  Dict[str, torch.Tensor]]):
    """Encode S consecutive superframes at once, batched over B*S.

    The reference's serial state st->vq_mem (lpcnet_enc.c:708-712) is only
    the QUANTIZED frame-3 cepstrum, which depends on nothing but its own
    superframe's features (frames 0-2 are quantized against vq_mem but
    never feed it). So the 3-stage M-best search runs for every
    superframe in one (B*S)-row pass, the vq_mem chain is a shift of its
    outputs (not a loop), and the diff-VQ, interpolation and LPC stage
    batch over B*S as well: the packets are those of S sequential
    encode_superframe calls.

    feats: (B, 4*S, 36) features computed with quantize_pitch=True; sps:
    the list of S superframe pitch dicts from features.compute_features,
    or the same stacked with a leading S axis.
    Returns (packets (B, S, 8) uint8, quantized feats (B, 4*S, 36), the
    last vq_mem (B, 18))."""
    B, T, Fdim = feats.shape
    S = T // 4
    if isinstance(sps, (list, tuple)):
        sps = {k: torch.stack([sp[k] for sp in sps]) for k in sps[0]}
    # (S, B, ...) pitch leaves -> (B*S, ...), superframe-major per stream
    sp_flat = {k: v.movedim(0, 1).reshape((B * S,) + v.shape[2:])
               for k, v in sps.items()}
    flat, c0_id, entries = _quantize_frame3(
        codebooks, feats.reshape(B * S, 4, Fdim))
    q3 = flat[:, 3, :NB_BANDS].reshape(B, S, NB_BANDS)
    mems = torch.cat([vq_mem[:, None], q3[:, :-1]], dim=1)
    buf, fq, _ = _finish_encode(codebooks, flat,
                                mems.reshape(B * S, NB_BANDS), sp_flat,
                                c0_id, entries)
    return buf.reshape(B, S, 8), fq.reshape(B, T, Fdim), q3[:, -1]


def decode_packet(codebooks: Codebooks, buf: torch.Tensor,
                  vq_mem: torch.Tensor):
    """(B, 8) uint8 and (B, 18) vq_mem -> ((B, 4, 36) features, new
    vq_mem). Mirrors decode_packet (lpcnet_dec.c:81-155); the LPC tail is
    left zero: synthesis derives LPC from the cepstrum (run_frame_network,
    lpcnet.c:109-115)."""
    fld = packet.unpack(buf)
    B = buf.shape[0]
    f = torch.zeros((B, 4, NB_TOTAL_FEATURES), dtype=torch.float32,
                    device=buf.device)
    modulation = fld["modulation"] - 4
    voiced = modulation != -4
    modulation = torch.where(voiced, modulation, 0)
    corr_id = fld["corr_id"].to(torch.float32)
    frame_corr = torch.where(voiced, 0.3875 + 0.175 * corr_id,
                             0.0375 + 0.075 * corr_id)
    f[:, :, NB_BANDS] = quantized_pitch(fld["main_pitch"], modulation)
    f[:, :, NB_BANDS + 1] = (frame_corr - 0.5)[:, None]

    f[:, 3, 0] = (fld["c0"] - 64).to(torch.float32) / 4.0
    f[:, 3, 1:NB_BANDS] = (codebooks["cb1"][fld["vq_end0"].long()]
                           + codebooks["cb2"][fld["vq_end1"].long()]
                           + codebooks["cb3"][fld["vq_end2"].long()])
    vq_mid = fld["vq_mid"]
    sign = torch.where(vq_mid >= 4096, -1.0, 1.0)
    idx = (vq_mid % 4096).long()
    diff = sign[:, None] * codebooks["diff4"][idx]
    q3 = f[:, 3, :NB_BANDS]
    preds = torch.stack([0.5 * (vq_mem + q3), 0.5 * (vq_mem + q3), vq_mem,
                         q3], dim=1)                        # (B, 4, 18)
    pred = preds.gather(1, (idx & 3)[:, None, None].expand(
        B, 1, NB_BANDS))[:, 0]
    f[:, 1, :NB_BANDS] = diff + pred
    nf0, nf2 = vq.perform_double_interp(
        f[:, 0, :NB_BANDS], f[:, 1, :NB_BANDS], f[:, 2, :NB_BANDS],
        f[:, 3, :NB_BANDS], vq_mem, fld["interp_id"])
    f[:, 0, :NB_BANDS] = nf0
    f[:, 2, :NB_BANDS] = nf2
    return f, f[:, 3, :NB_BANDS]


def decode_packets(codebooks: Codebooks, bufs: torch.Tensor,
                   vq_mem: torch.Tensor):
    """S packets per stream, one decode_packet per superframe in order:
    (B, S, 8) uint8 -> ((B, 4*S, 36) features, the last vq_mem)."""
    fs: List[torch.Tensor] = []
    for s in range(bufs.shape[1]):
        f, vq_mem = decode_packet(codebooks, bufs[:, s], vq_mem)
        fs.append(f)
    B = bufs.shape[0]
    out = torch.cat(fs, dim=1) if fs else torch.zeros(
        (B, 0, NB_TOTAL_FEATURES), device=bufs.device)
    return out, vq_mem
