"""DRED application layer: encode feature redundancy, decode on loss (the
port of lpcnet_tpu/dred.py; reference training_tf2/fec_encoder.py:200-305,
C inference src/dred_rdovae.c).

Features are encoded to 50 Hz latents; a redundancy payload for packet n
carries the latents of the last `num_dframes` 20-ms dframes, quantized
with per-position quantizers that get coarser with age (quant_id_ramp),
plus the PVQ-quantized decoder resume state of the oldest dframe. On loss,
the decoder rebuilds the feature history from the latest payload received.

    params, cfg = convert.load_dred()          # shipped weights, the card
    dc = DREDCodec(params, cfg)
    zd, sd = dc.encode(feats20)                # (B, T, 20), T % 4 == 0
    sym, qid = dc.quantize_payload(zd[:, :s])  # payload of packet s
    feats = dc.decode(sym, qid, sd[:, s - n])  # (B, 4n, 20), oldest first

A live sender encodes as the audio comes, one dframe at a time, on state
that each stream keeps on the device between calls (the C encoder's
RDOVAEEncState, src/dred_rdovae_enc.c:38-95), and sends a payload for
every dframe:

    st = dc.init_state(B)                      # B fresh streams
    out = dc.step(st, feats4)                  # (B, 4k, 20): k dframes
    out["symbols"], out["oldest_state"]        # (B, k, n, 80), (B, k, 24)
"""
import dataclasses

import numpy as np
import torch

from . import convert
from .device import resolve_device
from .models import rdovae as rv
from .utils import graphs, profiling


@dataclasses.dataclass(frozen=True)
class DREDConfig:
    num_dframes: int = 16          # redundancy span: 16 * 20 ms = 320 ms
    # a high q is a high lambda and a low rate, so q3 is the fine end and
    # q15 the coarse end; the newest dframe is the finest
    # (fec_encoder.py:200-209, :242-243)
    q0: int = 3                    # newest dframe's quant level
    q1: int = 15                   # oldest dframe's quant level


def quant_id_ramp(cfg: DREDConfig) -> np.ndarray:
    """Per-position quantizer ids, newest -> oldest (fec_encoder.py:200-209:
    older redundancy is coarser; ids index the lambda embedding). np.round
    rounds half to even, as jnp.round and torch.round do."""
    i = np.arange(cfg.num_dframes, dtype=np.float32)
    ramp = cfg.q0 + (cfg.q1 - cfg.q0) * i / max(1, cfg.num_dframes - 1)
    return np.round(ramp).astype(np.int32)


class DREDCodec:
    def __init__(self, params, cfg: rv.RDOVAEConfig = rv.RDOVAEConfig(),
                 dred_cfg: DREDConfig = DREDConfig(), device=None):
        """params: the port's RDO-VAE parameter dict (convert.load_dred).
        device: None means the card, and raises where there is none."""
        self.device = resolve_device(device)
        self.params = convert.to_device(params, self.device)
        self.cfg = cfg
        self.dred = dred_cfg
        # the payload's quant ids, newest first, uploaded once, and their
        # quantizers: under a fixed ramp, constants of the codec
        self.qid = torch.as_tensor(quant_id_ramp(dred_cfg), device=self.device)
        with torch.no_grad():
            qp = rv.quant_params(self.params, self.qid, cfg)
            self._scale, self._dead_zone = qp["scale"], qp["dead_zone"]
            self._taps = rv.conv_taps(self.params)
        # jit-compiled as the JAX package's are (lpcnet_tpu/dred.py:54-55):
        # on the card the first call of each argument signature captures a
        # CUDA graph and every call replays it (utils/graphs.py)
        self._encode = graphs.jit(self._encode_impl, "DREDCodec.encode")
        self._decode = graphs.jit(self._decode_impl, "DREDCodec.decode")

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def encode(self, feats):
        """feats: (B, T, 20), T % 4 == 0. Returns the per-dframe latents
        zd (B, T/4, 80) and the PVQ-quantized resume states sd
        (B, T/4, 24)."""
        return self._encode(self._f32(feats))

    @torch.no_grad()
    def _encode_impl(self, feats):
        z, state = rv.encode(self.params, feats, self.cfg)
        # dframe rate: every second pair step, the one ending the dframe
        return z[:, 1::2], rv.pvq_quantize(state[:, 1::2], self.cfg.pvq_k)

    def _symbols(self, window: torch.Tensor) -> torch.Tensor:
        """Symbols of latents (..., n, 80), newest first, under the age
        ramp's quantizers."""
        dze = rv.apply_dead_zone(window * self._scale, self._dead_zone)
        return torch.round(dze).to(torch.int32)

    @torch.no_grad()
    def quantize_payload(self, zd):
        """Quantize the last num_dframes latents with the age ramp.
        zd: (B, S, 80) with S >= num_dframes. Returns (symbols (B, n, 80)
        int32, newest first; the quant ids used (n,) int32)."""
        tail = torch.flip(self._f32(zd)[:, -self.dred.num_dframes:], [1])
        return self._symbols(tail), self.qid

    def init_state(self, batch: int) -> "EncoderState":
        """The encoder state of `batch` fresh streams, on the device:
        zeros, as encode starts."""
        c, n = self.cfg, self.dred.num_dframes

        def z(*shape):
            return torch.zeros((batch,) + shape, device=self.device)
        return EncoderState({"gru": z(3, c.cond_size),
                             "carry": z(c.nb_latents),
                             "latents": z(n, c.nb_latents),
                             "states": z(n, c.state_dim)})

    def step(self, state: "EncoderState", feats):
        """Advance every stream of `state` by k dframes, in place. feats:
        (B, 4k, 20). Returns a dict of each dframe's "latents" (B, k, 80)
        and PVQ "states" (B, k, 24), what encode gives on the whole
        history, and its payload: "symbols" (B, k, n, 80) int32, newest
        first, what quantize_payload gives on the history up to that
        dframe, and "oldest_state" (B, k, 24), the PVQ state of the
        payload's oldest dframe (latents and states before a stream's
        start are zeros).

        On the card each k has two graphs.loop_steps on the state's own
        tensors (first call eager, second captured, then replays), with
        nothing copied in but feats: "DREDCodec.step.recurrent", the
        GRUs' first recurrent products, which need no features, launched
        first, so that the card works on them while the host copies feats
        in and launches "DREDCodec.step", the rest."""
        k = feats.shape[1] // 4
        steps = state.steps.get(k)
        if steps is None:
            steps = state.steps[k] = self._loop_steps(state, feats.shape)
        recur, rest = steps
        recur()
        rest.bufs["feats"].copy_(self._f32(feats))
        rest()
        B = feats.shape[0]
        profiling.counters["dred.dframes"] += B * k
        profiling.counters["dred.payloads"] += B * k
        return {name: v.clone() for name, v in rest.bufs["out"].items()}

    def _loop_steps(self, state: "EncoderState", feats_shape):
        """The two loop_steps of `state` for feats of `feats_shape`, on
        their input and output buffers (step)."""
        B, k = feats_shape[0], feats_shape[1] // 4
        c, n = self.cfg, self.dred.num_dframes

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        recur = z(3, B, 3 * c.cond_size)
        rest = {"feats": z(B, 4 * k, c.nb_features), "state": state.tensors,
                "recur": recur,
                "out": {"latents": z(B, k, c.nb_latents),
                        "states": z(B, k, c.state_dim),
                        "symbols": z(B, k, n, c.nb_latents,
                                     dtype=torch.int32),
                        "oldest_state": z(B, k, c.state_dim)}}
        return (graphs.loop_step(self._recur_impl,
                                 {"state": state.tensors, "recur": recur},
                                 "DREDCodec.step.recurrent"),
                graphs.loop_step(self._step_impl, rest, "DREDCodec.step"))

    @torch.no_grad()
    def _recur_impl(self, bufs):
        with profiling.span("dred_stack"):
            rv.recurrent_products(self.params, bufs["state"]["gru"],
                                  bufs["recur"])

    @torch.no_grad()
    def _step_impl(self, bufs):
        cfg, n = self.cfg, self.dred.num_dframes
        state, out = bufs["state"], bufs["out"]
        with profiling.span("dred_stack"):
            pre, gru = rv.encode_stack(self.params, bufs["feats"],
                                       state["gru"], cfg, bufs["recur"])
        with profiling.span("dred_heads", joined=True):
            z, s, carry = rv.encode_heads(self.params, self._taps,
                                          state["carry"], pre, cfg)
            s = rv.pvq_quantize(s, cfg.pvq_k)
        with profiling.span("dred_payload", joined=True):
            k = z.shape[1]
            # every latent and state of the last n + k - 1 dframes, newest
            # first; dframe j of the k (oldest first) has the n from k-1-j
            zs = torch.cat([torch.flip(z, [1]), state["latents"]], dim=1)
            ss = torch.cat([torch.flip(s, [1]), state["states"]], dim=1)
            window = torch.flip(zs.unfold(1, n, 1)[:, :k], [1])
            out["latents"].copy_(z)
            out["states"].copy_(s)
            out["symbols"].copy_(self._symbols(window.transpose(-1, -2)))
            out["oldest_state"].copy_(torch.flip(ss[:, n - 1:n - 1 + k],
                                                 [1]))
            state["gru"].copy_(gru)
            state["carry"].copy_(carry)
            state["latents"].copy_(zs[:, :n])
            state["states"].copy_(ss[:, :n])

    def decode(self, sym, qid, state):
        """Features from a redundancy payload. sym: (B, n, 80) symbols,
        newest first; qid: (n,) quant ids; state: (B, 24) resume state of
        the oldest dframe. Returns (B, n*4, 20) features, oldest first
        (DRED_rdovae_decode_all, src/dred_rdovae.c:38-52)."""
        return self._decode(self._f32(sym),
                            torch.as_tensor(qid, device=self.device),
                            self._f32(state))

    @torch.no_grad()
    def _decode_impl(self, sym, qid, state):
        qp = rv.quant_params(self.params, qid, self.cfg)
        return rv.decode(self.params, torch.flip(sym / qp["scale"], [1]),
                         state, self.cfg)


class EncoderState:
    """The encoder state of B streams on the device (the C encoder's
    RDOVAEEncState, src/dred_rdovae_enc.c, batched), which
    DREDCodec.step updates in place. tensors: "gru" the three GRUs'
    states (B, 3, cond_size), "carry" the last dframe's share of the next
    latent (B, 80; rv.encode_heads), and the newest num_dframes latents
    (B, n, 80) and PVQ states (B, n, 24), newest first. steps: the two
    graphs.loop_steps of each count of dframes a call, on their input and
    output buffers (DREDCodec.step)."""

    def __init__(self, tensors):
        self.tensors = tensors
        self.steps = {}


@torch.no_grad()
def roundtrip(params, cfg: rv.RDOVAEConfig, feats: torch.Tensor,
              quant: int = 0):
    """The RDO-VAE's quality measure (the recipe of the JAX package's
    shipped-weights test, tests/test_rdovae.py:150-181, and of
    tools/eval_dred.py): encode feats (B, T, 20), T % 8 == 0; every second
    latent and PVQ state; symbols of every dframe at level `quant`; decode
    the whole sequence from the first state. Returns (the RMS of the
    decoded features against feats, sq_rate_metric bits per dframe of the
    symbols)."""
    z, state = rv.encode(params, feats, cfg)
    zd, sd = z[:, 1::2], rv.pvq_quantize(state[:, 1::2], cfg.pvq_k)
    qp = rv.quant_params(params, torch.full(zd.shape[:2], quant,
                                            device=zd.device), cfg)
    dze = rv.apply_dead_zone(zd * qp["scale"], qp["dead_zone"])
    bits = float(rv.sq_rate_metric(dze, qp["hard"]))
    out = rv.decode(params, torch.round(dze) / qp["scale"], sd[:, 0], cfg)
    n = min(out.shape[1], feats.shape[1])
    rms = float(torch.sqrt(torch.mean((out[:, :n] - feats[:, :n]) ** 2)))
    return rms, bits
