"""Packet-loss concealment engines (the port of lpcnet_tpu/plc.py; reference
src/lpcnet_plc.c).

Batched, masked design: every 10-ms step processes B independent streams,
each with its own loss flag; all control paths (good frame, first good frame
after loss = "blend", lost frame) are computed batched and selected per
stream with masks.

PLCEngine (causal) runs ONE synthesis launch and ONE feature pass per
frame: lost rows free-run, good rows teacher-force the whole frame, blend
rows free-run the first half and force the second, a per-row forcing
window inside one kernel launch (kernels/sample_cuda.synth_samples,
force_from). The feature pass is pipelined one frame late (the extractor
state advances on the PREVIOUS output while the CURRENT input's features
are computed), so the good-path features exist before the launch; for good
streams output == input, so they are the features of the unpipelined form.

Its deliberate divergences from the C, as in the JAX package:
  * teacher-forced state updates run on every good frame (the reference's
    `#else` branch, lpcnet_plc.c:273-279; its default skips them);
  * a lost frame synthesizes all 160 samples from the newly predicted
    features (the C synthesizes the first 80 from the previous frame's
    conditions, lpcnet_plc.c:315-320); the blend cross-fade hides both;
  * on a blend frame the sample state advances free-running over the first
    80 samples and teacher-forced on the input thereafter;
  * KISS99 draws advance on masked-off paths; per-stream outputs remain
    deterministic functions of the inputs.

NonCausalPLCEngine delays its output by 80 samples and blends the first
good frame after a loss with a time-reversed synthesis. Its fully forced
synthesis calls go to kernels/sample_cuda.teacher_advance, every other call
to synth_samples.

StrictCausalPLCEngine removes PLCEngine's divergences: it is the replica of
the C's default causal engine (deferred feature buffer, 400-sample delay
buffer with teacher-forced catch-up, 80/80 split conceal); eight
synth_samples calls per step, each with per-stream active counts.

The feature queue for FEC follows lpcnet_plc_fec_add / get_fec_or_pred /
fec_rewind (lpcnet_plc.c:111-173). On a CUDA device every synthesis call
launches a hand-written kernel; device="cpu" runs the plain PyTorch loops.
"""
import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from . import convert
from . import features as F
from .constants import (FRAME_SIZE, LPC_ORDER, NB_BANDS, NB_FEATURES,
                        NB_TOTAL_FEATURES, PLC_MAX_FEC, TRAINING_OFFSET)
from .device import resolve_device
from .kernels import sample_cuda, sample_scan
from .models import lpcnet as lpcnet_model
from .models import plc as plc_model
from .ops import burg as burg_ops

# energy attenuation after repeated losses (lpcnet_plc.c:292)
ATT_TABLE = np.array([0, 0, -.2, -.2, -.4, -.4, -.8, -.8, -1.6, -1.6],
                     dtype=np.float32)
DC_CONST = 0.003


@dataclasses.dataclass(frozen=True)
class PLCOptions:
    remove_dc: bool = False


def _sel(mask: torch.Tensor, a, b):
    """Per-stream select between two state dicts (or tensors): rows where
    mask (B,) is set come from a, the others from b."""
    if isinstance(a, dict):
        return {k: _sel(mask, a[k], b[k]) for k in a}
    return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


def _dc_track(mem: torch.Tensor, x: torch.Tensor):
    """DC follower over a frame (lpcnet_plc.c:195-204): per sample the
    rounded estimate lp = floor(.5 + m), then m += DC_CONST * (x - m).
    mem (B,), x (B, n). Returns (new mem, lp (B, n))."""
    lps = []
    for i in range(x.shape[1]):
        lps.append(torch.floor(0.5 + mem))
        mem = mem + DC_CONST * (x[:, i] - mem)
    return mem, torch.stack(lps, dim=1)


def _dc_follow(mem: torch.Tensor, x: torch.Tensor,
               track: Optional[torch.Tensor] = None) -> torch.Tensor:
    """m += DC_CONST * (x - m) over the samples of x (B, n) where track
    (B, n) is set (everywhere if None). Returns the new mem."""
    for i in range(x.shape[1]):
        new = mem + DC_CONST * (x[:, i] - mem)
        mem = new if track is None else torch.where(track[:, i], new, mem)
    return mem


def _attenuation(loss_count: torch.Tensor) -> torch.Tensor:
    """c0 attenuation after loss_count losses (lpcnet_plc.c:316-319)."""
    table = torch.as_tensor(ATT_TABLE, device=loss_count.device)
    return torch.where(
        loss_count >= 10,
        float(ATT_TABLE[9]) - 2.0 * (loss_count - 9).to(torch.float32),
        table[torch.clamp(loss_count, 0, 9).long()])


def _conceal_features(pred: torch.Tensor, att: torch.Tensor) -> torch.Tensor:
    """(B, 20) features with c0 attenuated and floored at -10, zero-padded
    to the 36 the frame network takes."""
    c0 = torch.clamp(pred[:, :1] + att[:, None], min=-10.0)
    return _pad36(torch.cat([c0, pred[:, 1:]], dim=-1))


def _pad36(feats20: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(feats20,
                                   (0, NB_TOTAL_FEATURES - NB_FEATURES))


def _fade_window(device) -> torch.Tensor:
    """Raised-cosine weights over a half frame (lpcnet_plc.c:225-229)."""
    i = torch.arange(TRAINING_OFFSET, dtype=torch.float32, device=device)
    return 0.5 - 0.5 * torch.cos(math.pi * i / TRAINING_OFFSET)


class _Engine:
    """What the engines share: parameters on a device, the dispatch of a
    synthesis call to its kernel, and run() as a loop of step()."""

    def __init__(self, lpcnet_params, plc_params,
                 cfg: Optional[lpcnet_model.LPCNetConfig] = None,
                 plc_cfg: Optional[plc_model.PLCConfig] = None,
                 options: PLCOptions = PLCOptions(), device=None,
                 variant: str = "flat"):
        """lpcnet_params, plc_params: the port's parameter dicts
        (convert.load_lpcnet / load_plc / params_from_numpy). device: None
        means the card, and raises where there is none. variant: 'flat'
        (flat sampling tree) or 'base' (walked tree); same bits."""
        self.device = resolve_device(device)
        if variant not in sample_cuda.VARIANTS:
            raise ValueError(f"variant must be one of {sample_cuda.VARIANTS}")
        self.cfg = cfg or self._default_cfg()
        self.plc_cfg = plc_cfg or plc_model.PLCConfig()
        self.params = convert.to_device(lpcnet_params, self.device)
        self.plc_params = convert.to_device(plc_params, self.device)
        self.tables = lpcnet_model.precompute_sample_tables(self.params,
                                                            self.cfg)
        self.options = options
        self.variant = variant

    @staticmethod
    def _default_cfg():
        return lpcnet_model.LPCNetConfig()

    def _synth_samples(self, synth_state, cond, nsamples, target=None,
                       preload=None, n_active=None, force_from=None):
        """Sample synthesis under one condition set. FULLY teacher-forced
        calls (a target, no partial window and no active counts) take
        teacher_advance: the forced output IS the target, so only the GRU
        recurrences run per sample. Every other call takes synth_samples.
        force_from: (B,) int32, samples >= force_from are teacher-forced
        too; n_active: (B,) int32, steps >= n_active freeze the stream."""
        cond = {k: cond[k].contiguous() for k in ("cond_a", "cond_b", "lpc")}
        if target is not None:
            target = target.contiguous()
            if preload is None and n_active is None and force_from is None:
                return sample_cuda.teacher_advance(
                    self.tables, synth_state, cond, self.cfg, target)
        return sample_cuda.synth_samples(
            self.tables, synth_state, cond, self.cfg, nsamples,
            target=target, preload=preload, n_active=n_active,
            force_from=force_from, variant=self.variant)

    def _zeros(self, *shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _bool(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.bool, device=self.device)

    @torch.no_grad()
    def run(self, state, pcm, lost):
        """Process T frames: pcm (B, T*160), lost (B, T) bool -> (state,
        (B, T*160)). A loop of T step() calls."""
        pcm, lost = self._f32(pcm), self._bool(lost)
        outs = []
        for t in range(lost.shape[1]):
            state, out = self.step(
                state, pcm[:, t * FRAME_SIZE:(t + 1) * FRAME_SIZE],
                lost[:, t])
            outs.append(out)
        return state, torch.cat(outs, dim=1)


class PLCEngine(_Engine):
    """The causal engine: one synthesis launch per 10-ms step."""

    def init_state(self, batch: int) -> Dict[str, Any]:
        dev = self.device
        net = plc_model.init_net_state(batch, self.plc_cfg, dev)
        return {
            "synth": sample_scan.init_state(batch, self.cfg, device=dev),
            "fnet": lpcnet_model.frame_net_init_state(batch, self.cfg, dev),
            "enc": F.init_state(batch, dev),
            "plc_net": net,
            "plc_copies": {k: v[:, None].repeat(1, self.cfg.lookahead + 1, 1)
                           for k, v in net.items()},
            "loss_count": self._zeros(batch, dtype=torch.int32),
            "blend": self._zeros(batch, dtype=torch.bool),
            "fec": self._zeros(batch, PLC_MAX_FEC, NB_FEATURES),
            "fec_fill": self._zeros(batch, dtype=torch.int32),
            "fec_read": self._zeros(batch, dtype=torch.int32),
            "fec_keep": self._zeros(batch, dtype=torch.int32),
            "fec_skip": self._zeros(batch, dtype=torch.int32),
            "dc_mem": self._zeros(batch),
            "syn_dc": self._zeros(batch),
            # previous frame's output audio: the extractor state advances
            # on it one step late (see step), so that the good-path
            # features exist BEFORE the synthesis launch
            "prev_out": self._zeros(batch, FRAME_SIZE),
        }

    @torch.no_grad()
    def fec_add(self, state, feats, mask=None):
        """Queue FEC features (lpcnet_plc_fec_add, lpcnet_plc.c:111-132).
        feats: (B, 20); mask: (B,) bool selects streams that receive data."""
        feats = self._f32(feats)
        B = feats.shape[0]
        mask = (torch.ones((B,), dtype=torch.bool, device=self.device)
                if mask is None else self._bool(mask))
        fill = state["fec_fill"]
        # compaction when full: shift window [keep, fill) to the origin
        shift = torch.where(fill >= PLC_MAX_FEC, state["fec_keep"], 0)
        slot = torch.arange(PLC_MAX_FEC, device=self.device)
        idx = (slot[None, :] + shift[:, None]) % PLC_MAX_FEC
        fec = torch.gather(state["fec"], 1,
                           idx[..., None].expand(-1, -1, NB_FEATURES).long())
        fill = fill - shift
        wpos = torch.clamp(fill, 0, PLC_MAX_FEC - 1)
        upd = (slot[None, :] == wpos[:, None]) & mask[:, None]
        fec = torch.where(upd[..., None], feats[:, None, :], fec)
        return {**state, "fec": fec,
                "fec_fill": torch.where(
                    mask, torch.clamp(fill + 1, max=PLC_MAX_FEC), fill),
                "fec_read": state["fec_read"] - shift,
                "fec_keep": torch.clamp(state["fec_keep"] - shift, min=0)}

    def fec_clear(self, state):
        z = torch.zeros_like(state["fec_fill"])
        return {**state, "fec_fill": z, "fec_read": z, "fec_keep": z,
                "fec_skip": z}

    @torch.no_grad()
    def step(self, state, pcm, lost):
        """Process one 10-ms frame per stream.

        pcm: (B, 160) float (ignored where lost); lost: (B,) bool.
        Returns (new_state, output pcm (B, 160))."""
        pcm, lost = self._f32(pcm), self._bool(lost)
        B = pcm.shape[0]
        cfg = self.cfg

        # --- optional DC removal on the incoming audio
        # (lpcnet_plc.c:195-204)
        if self.options.remove_dc:
            dc_mem2, lp = _dc_track(state["dc_mem"] + state["syn_dc"], pcm)
            pcm_proc = torch.where(lost[:, None], pcm, pcm - lp)
            dc_mem = torch.where(lost, state["dc_mem"], dc_mem2)
            syn_dc = torch.where(lost, state["syn_dc"], 0.0)
        else:
            pcm_proc, lp = pcm, None
            dc_mem, syn_dc = state["dc_mem"], state["syn_dc"]

        # --- burg features of incoming audio (valid on good frames)
        burg36 = burg_ops.burg_cepstral_analysis(pcm_proc)

        # --- PIPELINED feature pass: advance the extractor on the PREVIOUS
        # frame's output (good streams' output was their input, lost/blend
        # streams' their synthesized/blended audio: the history the C
        # extractor sees, one step late), then compute this frame's input
        # features. ONE 2-frame analysis call: frame 1 = previous output
        # (advances the kept state), frame 2 = current input (features
        # only); the kept state is the mid state after frame 1.
        _, featsg, _, enc_mid = F.compute_features(
            state["enc"], torch.cat([state["prev_out"], pcm_proc], dim=-1),
            mode="single", return_mid=True)
        featg = featsg[:, 1, :NB_FEATURES]

        # --- FEC availability (get_fec_or_pred, lpcnet_plc.c:147-166)
        has_fec = ((state["fec_read"] < state["fec_fill"])
                   & (state["fec_skip"] == 0) & lost)
        rd = torch.clamp(state["fec_read"], 0, PLC_MAX_FEC - 1).long()
        fec_feat = state["fec"][torch.arange(B, device=self.device), rd]

        # --- ONE stacked PLC-net step for both the lost/blend input and
        # the good-path input
        zeros36 = self._zeros(B, 2 * NB_BANDS)
        zeros20 = self._zeros(B, NB_FEATURES)
        one = torch.ones((B, 1), dtype=torch.float32, device=self.device)
        in_blend = torch.cat([burg36, zeros20, one], dim=-1)
        in_lost = torch.cat([zeros36, zeros20, 0 * one], dim=-1)
        in_fec = torch.cat([zeros36, fec_feat, -one], dim=-1)
        blend = state["blend"] & ~lost
        x_lb = torch.where(lost[:, None],
                           torch.where(has_fec[:, None], in_fec, in_lost),
                           in_blend)
        in_good = torch.cat([burg36, featg, one], dim=-1)

        # restore plc state from the copy on blend (lpcnet_plc.c:217)
        copies = state["plc_copies"]
        plc_net_in = {k: torch.where(blend[:, None], copies[k][:, -1], cur)
                      for k, cur in state["plc_net"].items()}
        # push a copy before prediction on lost frames
        # (lpcnet_plc.c:305-314)
        new_copies = {
            k: torch.where(lost[:, None, None],
                           torch.cat([plc_net_in[k][:, None], cp[:, :-1]],
                                     dim=1), cp)
            for k, cp in copies.items()}

        st2 = {k: torch.cat([plc_net_in[k], state["plc_net"][k]], dim=0)
               for k in plc_net_in}
        plc2, pred2 = plc_model.step(self.plc_params, st2,
                                     torch.cat([x_lb, in_good], dim=0),
                                     self.plc_cfg)
        plc_lb = {k: v[:B] for k, v in plc2.items()}
        plc_g = {k: v[B:] for k, v in plc2.items()}
        pred = pred2[:B]

        # concealment features: FEC frame or prediction, with c0
        # attenuation (lpcnet_plc.c:316-319)
        lc = state["loss_count"]
        feat_lost = _conceal_features(
            torch.where(has_fec[:, None], fec_feat, pred), _attenuation(lc))

        # --- ONE synthesis launch for all three paths, selected per row by
        # the conditioning features and the forcing window:
        #   lost  rows free-run from the concealment features,
        #   good  rows teacher-force the whole frame on their input,
        #   blend rows free-run the first half (the continuation used by
        #         the cross-fade) and force the second half on the input.
        feats = torch.where(
            lost[:, None], feat_lost,
            _pad36(torch.where(blend[:, None], pred, featg)))
        new_fnet, cond = lpcnet_model.frame_net_step(
            self.params, self.tables, state["fnet"], feats, cfg)
        force_from = torch.where(
            lost, cfg.frame_size,
            torch.where(blend, TRAINING_OFFSET, 0)).to(torch.int32)
        new_synth, synth_out = self._synth_samples(
            state["synth"], cond, cfg.frame_size, target=pcm_proc,
            force_from=force_from)
        # first FEATURES_DELAY frames are silence (lpcnet.c:239-243)
        warm = new_fnet["frame_count"] > cfg.lookahead
        synth_out = torch.where(warm[:, None], synth_out, 0.0)

        # blend cross-fade over the first half frame
        # (lpcnet_plc.c:225-229)
        w = _fade_window(self.device)
        fade = w[None, :] * pcm_proc[:, :TRAINING_OFFSET] \
            + (1 - w)[None, :] * synth_out[:, :TRAINING_OFFSET]
        blended = torch.cat([fade, pcm_proc[:, TRAINING_OFFSET:]], dim=-1)
        output = torch.where(lost[:, None], synth_out,
                             torch.where(blend[:, None], blended, pcm_proc))

        # --- FEC bookkeeping: lost+fec consumes one frame; a good frame
        # discards one (lpcnet_plc.c:259-262); blend rewinds
        # FEATURES_DELAY (lpcnet_plc.c:234)
        fec_read = state["fec_read"]
        fec_skip = state["fec_skip"]
        good = ~lost & ~blend
        consume = has_fec | (good & (fec_read < state["fec_fill"])
                             & (fec_skip == 0))
        dec_skip = good & (fec_skip > 0)
        fec_read = torch.where(consume, fec_read + 1, fec_read)
        fec_skip = torch.where(dec_skip, fec_skip - 1, fec_skip)
        fec_keep = torch.maximum(
            state["fec_keep"], torch.clamp(fec_read - cfg.lookahead - 1,
                                           min=0))
        fec_read = torch.where(
            blend, torch.maximum(fec_keep, fec_read - cfg.lookahead),
            fec_read)

        # the extractor advances on the DC-REMOVED output next step
        prev_out = output

        # --- DC on concealed output (lpcnet_plc.c:330-335)
        if self.options.remove_dc:
            syn_dc = torch.where(lost, _dc_follow(syn_dc, output), syn_dc)
            dc_add = torch.floor(0.5 + dc_mem)
            output = torch.where(lost[:, None], output + dc_add[:, None],
                                 output + lp)

        return {**state,
                "synth": new_synth, "fnet": new_fnet, "enc": enc_mid,
                "prev_out": prev_out,
                "plc_net": _sel(lost | blend, plc_lb, plc_g),
                "plc_copies": new_copies,
                "loss_count": torch.where(
                    lost, torch.where(has_fec, 0, lc + 1), 0),
                "blend": lost, "fec_read": fec_read, "fec_skip": fec_skip,
                "fec_keep": fec_keep, "dc_mem": dc_mem,
                "syn_dc": syn_dc}, output


class StrictCausalPLCEngine(_Engine):
    """Replica of the reference causal PLC engine under its DEFAULT build
    flags (PLC_SKIP_UPDATES defined, blending enabled, lpcnet_plc.c:40,
    :64-66), unlike PLCEngine, which teacher-forces every good frame.

    Reference semantics reproduced here:
      * good frames only queue features into a 4-deep deferred buffer
        (run_frame_network_deferred, lpcnet.c:123-135); the sample-rate
        state stays frozen behind a PLC_BUF_SIZE (= FEATURES_DELAY*160+80
        = 400) sample delay buffer (lpcnet_private.h:77,92-94)
      * conceal first flushes the deferred features (lpcnet.c:137-145),
        teacher-forces the buffered samples in <=160-sample chunks
        (lpcnet_plc.c:298-312), then synthesizes 80 samples with the OLD
        conditions and 80 with the newly predicted features, the 80-sample
        split conceal (lpcnet_plc.c:315-320)
      * the first good frame after a loss cross-fades a free-run
        continuation into the input over 80 samples, restores the
        snapshot, and teacher-forces the blended audio
        (lpcnet_plc.c:215-231)

    Batched over streams with per-stream masks; every path is computed for
    every stream and selected, so one step is 8 synth_samples calls (4 of
    160 samples, 4 of 80; each with per-stream active counts, never the
    fully forced teacher_advance) and 10 frame_net_step calls. remove_dc
    is not supported in strict mode; FEC queueing works through PLCEngine's
    fec_add / fec_clear."""
    MAX_FEAT_BUF = 4      # conv1.ksize + conv2.ksize - 2 (lpcnet.c:124)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.options.remove_dc:
            raise ValueError("strict mode does not implement the DC filter")
        self.buf_size = self.cfg.lookahead * FRAME_SIZE + TRAINING_OFFSET

    fec_add = PLCEngine.fec_add
    fec_clear = PLCEngine.fec_clear

    def init_state(self, batch: int) -> Dict[str, Any]:
        cfg, dev = self.cfg, self.device
        net = plc_model.init_net_state(batch, self.plc_cfg, dev)
        i32 = torch.int32
        return {
            "synth": sample_scan.init_state(batch, cfg, device=dev),
            "fnet": lpcnet_model.frame_net_init_state(batch, cfg, dev),
            "enc": F.init_state(batch, dev),
            "plc_net": net,
            "plc_copies": {k: v[:, None].repeat(1, cfg.lookahead + 1, 1)
                           for k, v in net.items()},
            # conditions left by the last run_frame_network (zeros after
            # reset, like the calloc'd LPCNetState)
            "last_cond": {
                "cond_a": self._zeros(batch, 3 * cfg.gru_a_units),
                "cond_b": self._zeros(batch, 3 * cfg.gru_b_units),
                "lpc": self._zeros(batch, LPC_ORDER)},
            "feat_buf": self._zeros(batch, self.MAX_FEAT_BUF, NB_FEATURES),
            "feat_fill": self._zeros(batch, dtype=i32),
            "pcm_buf": self._zeros(batch, self.buf_size + FRAME_SIZE),
            "pcm_fill": torch.full((batch,), self.buf_size, dtype=i32,
                                   device=dev),
            "skip_analysis": self._zeros(batch, dtype=i32),
            "blend": self._zeros(batch, dtype=torch.bool),
            "features": self._zeros(batch, NB_FEATURES),
            "loss_count": self._zeros(batch, dtype=i32),
            "fec": self._zeros(batch, PLC_MAX_FEC, NB_FEATURES),
            "fec_fill": self._zeros(batch, dtype=i32),
            "fec_read": self._zeros(batch, dtype=i32),
            "fec_keep": self._zeros(batch, dtype=i32),
            "fec_skip": self._zeros(batch, dtype=i32),
        }

    # ------------------------------------------------------------------
    def _fnet_masked(self, fstate, last_cond, feats20, mask):
        """run_frame_network for masked streams; the others keep their
        state and conditions."""
        nf, cond = lpcnet_model.frame_net_step(
            self.params, self.tables, fstate, _pad36(feats20), self.cfg)
        cond = {k: cond[k] for k in ("cond_a", "cond_b", "lpc")}
        return _sel(mask, nf, fstate), _sel(mask, cond, last_cond)

    @staticmethod
    def _push_copy(copies, cur, mask):
        """Push the PLC-net state onto its copies where mask is set."""
        shifted = {k: torch.cat([cur[k][:, None], cp[:, :-1]], dim=1)
                   for k, cp in copies.items()}
        return _sel(mask, shifted, copies)

    def _feat_push(self, buf, fill, feats20, mask):
        """run_frame_network_deferred (lpcnet.c:123-135): append, dropping
        the oldest entry when the 4-deep buffer is full."""
        full = fill >= self.MAX_FEAT_BUF
        shifted = torch.where(full[:, None, None],
                              torch.cat([buf[:, 1:], buf[:, -1:]], dim=1),
                              buf)
        new_fill = torch.where(full, fill, fill + 1)
        slot = torch.arange(self.MAX_FEAT_BUF, device=buf.device)
        onehot = slot[None, :] == (new_fill - 1)[:, None]
        written = torch.where((onehot & mask[:, None])[..., None],
                              feats20[:, None, :], shifted)
        return (torch.where(mask[:, None, None], written, buf),
                torch.where(mask, new_fill, fill))

    def _get_fec_or_pred(self, plc, st, active, out_prev):
        """get_fec_or_pred (lpcnet_plc.c:147-166), batched: the queued FEC
        frame if there is one, else the network's prediction; the PLC net is
        updated either way. st: the fec_* leaves. Returns (features, plc
        state, fec leaves, took a FEC frame)."""
        B = out_prev.shape[0]
        has_fec = (st["fec_read"] < st["fec_fill"]) & (st["fec_skip"] == 0)
        rd = torch.clamp(st["fec_read"], 0, PLC_MAX_FEC - 1).long()
        fec_feat = st["fec"][torch.arange(B, device=self.device), rd]
        one = torch.ones((B, 1), dtype=torch.float32, device=self.device)
        in_fec = torch.cat([self._zeros(B, 2 * NB_BANDS), fec_feat, -one],
                           dim=-1)
        x = torch.where(has_fec[:, None], in_fec, torch.zeros_like(in_fec))
        new_plc, pred = plc_model.step(self.plc_params, plc, x, self.plc_cfg)
        out = torch.where(active[:, None],
                          torch.where(has_fec[:, None], fec_feat, pred),
                          out_prev)
        take = active & has_fec
        read = torch.where(take, st["fec_read"] + 1, st["fec_read"])
        keep = torch.where(
            take, torch.clamp(torch.maximum(
                st["fec_keep"], read - self.cfg.lookahead - 1), min=0),
            st["fec_keep"])
        skip = torch.where(active & ~has_fec & (st["fec_skip"] > 0),
                           st["fec_skip"] - 1, st["fec_skip"])
        return (out, _sel(active, new_plc, plc),
                {**st, "fec_read": read, "fec_keep": keep, "fec_skip": skip},
                take)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state, pcm, lost):
        """Process one 10-ms frame per stream.

        pcm: (B, 160) float (ignored where lost); lost: (B,) bool.
        Returns (new_state, output pcm (B, 160))."""
        pcm, lost = self._f32(pcm), self._bool(lost)
        B = pcm.shape[0]
        cfg = self.cfg
        off, FS = TRAINING_OFFSET, FRAME_SIZE
        i32 = torch.int32
        burg36 = burg_ops.burg_cepstral_analysis(pcm)
        zeros20 = self._zeros(B, NB_FEATURES)
        one = torch.ones((B, 1), dtype=torch.float32, device=self.device)

        def counts(mask, n):
            """n_active: n where mask is set, else 0."""
            return torch.where(mask, n, 0).to(i32)

        # =========== CONCEAL path (applied where lost) ===========
        # 1. flush the deferred feature buffer (run_frame_network_flush)
        fnetC, condC = state["fnet"], state["last_cond"]
        for j in range(self.MAX_FEAT_BUF):
            fnetC, condC = self._fnet_masked(
                fnetC, condC, state["feat_buf"][:, j],
                (j < state["feat_fill"]) & lost)
        # 2. teacher-forced catch-up over the delay buffer
        #    (lpcnet_plc.c:298-312)
        synthC = state["synth"]
        plcC, copiesC = state["plc_net"], state["plc_copies"]
        fecC = {k: state[k] for k in
                ("fec", "fec_fill", "fec_read", "fec_keep", "fec_skip")}
        bufC, fillC = state["pcm_buf"], state["pcm_fill"]
        skipC = state["skip_analysis"]
        featuresC = state["features"]
        for _ in range((self.buf_size + FS + FS - 1) // FS):
            act = (fillC > 0) & lost
            upd = torch.clamp(fillC, 0, FS)
            copiesC = self._push_copy(copiesC, plcC, act)
            featuresC, plcC, fecC, _ = self._get_fec_or_pred(
                plcC, fecC, act, featuresC)
            fnetC, condC = self._fnet_masked(fnetC, condC, featuresC, act)
            synthC, _ = self._synth_samples(
                synthC, condC, FS, target=bufC[:, :FS], preload=upd,
                n_active=counts(act, upd))
            shifted = torch.cat([bufC[:, FS:], self._zeros(B, FS)], dim=-1)
            bufC = torch.where(act[:, None], shifted, bufC)
            fillC = torch.where(act, fillC - upd, fillC)
            skipC = skipC + act.to(i32)
        # 3. 80 samples with the OLD conditions, 80 with the new prediction
        #    (the 80-sample split conceal, lpcnet_plc.c:313-320)
        copiesC = self._push_copy(copiesC, plcC, lost)
        synthC, out_head = self._synth_samples(
            synthC, condC, FS - off, n_active=counts(lost, FS - off))
        featuresC, plcC, fecC, got_fec = self._get_fec_or_pred(
            plcC, fecC, lost, featuresC)
        lcC = torch.where(got_fec, 0, state["loss_count"] + 1)
        c0 = torch.clamp(featuresC[:, :1] + _attenuation(lcC)[:, None],
                         min=-10.0)
        featuresC = torch.cat([c0, featuresC[:, 1:]], dim=-1)
        fnetC, condC = self._fnet_masked(fnetC, condC, featuresC, lost)
        synthC, out_tail = self._synth_samples(
            synthC, condC, off, n_active=counts(lost, off))
        out_conceal = torch.cat([out_head, out_tail], dim=-1)

        # =========== UPDATE path (good frames) ===========
        blend = ~lost & state["blend"]
        goodA = ~lost & ~blend
        # --- blend: restore copy, predict, cross-fade, teacher-force
        #     (lpcnet_plc.c:210-231)
        plc_rest = _sel(blend, {k: c[:, -1]
                                for k, c in state["plc_copies"].items()},
                        state["plc_net"])
        plcB, predB = plc_model.step(
            self.plc_params, plc_rest,
            torch.cat([burg36, zeros20, one], dim=-1), self.plc_cfg)
        featbufB, featfillB = state["feat_buf"], state["feat_fill"]
        for _ in range(cfg.lookahead):       # lpcnet_plc.c:219-222
            featbufB, featfillB = self._feat_push(featbufB, featfillB,
                                                  predB, blend)
        fnetB, condB = self._fnet_masked(state["fnet"], state["last_cond"],
                                         predB, blend)
        n_blend = counts(blend, FS - off)
        _, tmp80 = self._synth_samples(state["synth"], condB, FS - off,
                                       n_active=n_blend)
        w = _fade_window(self.device)
        faded = torch.floor(0.5 + w[None, :] * pcm[:, :FS - off]
                            + (1 - w)[None, :] * tmp80)
        out_blend = torch.cat([faded, pcm[:, FS - off:]], dim=-1)
        synthB, _ = self._synth_samples(
            state["synth"], condB, FS - off, target=faded,
            preload=torch.full((B,), FS - off, dtype=i32,
                               device=self.device),
            n_active=n_blend)
        # pcm buffer after blend: last 80 input samples (lpcnet_plc.c:242)
        bufB = torch.cat([pcm[:, FS - off:],
                          self._zeros(B, self.buf_size + FS - off)], dim=-1)

        # final output (needed now for the shared feature pass)
        output = torch.where(lost[:, None], out_conceal,
                             torch.where(blend[:, None], out_blend, pcm))

        # --- shared feature pass: every path extracts the features of its
        #     output frame through the same streaming state
        new_enc, featsg, _ = F.compute_features(state["enc"], output,
                                                mode="single")
        featg = featsg[:, 0, :NB_FEATURES]

        # --- good non-blend: PLC-net update + FEC discard
        #     (lpcnet_plc.c:251-262)
        plcG, predG = plc_model.step(
            self.plc_params, state["plc_net"],
            torch.cat([burg36, featg, one], dim=-1), self.plc_cfg)
        gskip = goodA & (state["fec_skip"] > 0)
        gread = goodA & ~gskip & (state["fec_read"] < state["fec_fill"])
        fec_readU = torch.where(gread, state["fec_read"] + 1,
                                state["fec_read"])
        fec_skipU = torch.where(gskip, state["fec_skip"] - 1,
                                state["fec_skip"])
        fec_keepU = torch.where(
            goodA, torch.clamp(torch.maximum(
                state["fec_keep"], fec_readU - cfg.lookahead - 1), min=0),
            state["fec_keep"])

        # pcm delay buffer for good frames: steady state keeps the last
        # buf_size samples; catch-up frames append at pcm_fill
        # (lpcnet_plc.c:244-247 vs :281-286)
        steady = goodA & (state["skip_analysis"] == 0)
        steady_buf = torch.cat([state["pcm_buf"][:, FS:self.buf_size], pcm,
                                self._zeros(B, FS)], dim=-1)
        pos = torch.arange(self.buf_size + FS, device=self.device)[None, :]
        offl = state["pcm_fill"][:, None]
        in_window = (pos >= offl) & (pos < offl + FS)
        appended = torch.where(
            in_window,
            torch.gather(pcm, -1, torch.clamp(pos - offl, 0, FS - 1).long()),
            state["pcm_buf"])
        bufU = torch.where(
            steady[:, None], steady_buf,
            torch.where((goodA & ~steady)[:, None], appended,
                        torch.where(blend[:, None], bufB,
                                    state["pcm_buf"])))
        fillU = torch.where(
            steady, state["pcm_fill"],
            torch.where(goodA, state["pcm_fill"] + FS,
                        torch.where(blend, off, state["pcm_fill"])))

        # deferred feature push for all good frames (lpcnet_plc.c:266,
        # :275-277)
        featbufU, featfillU = self._feat_push(featbufB, featfillB, featg,
                                              ~lost)
        skipU = torch.where(~lost & (state["skip_analysis"] > 0),
                            state["skip_analysis"] - 1,
                            state["skip_analysis"])

        # =========== merge ===========
        def merge(c, b, g):
            """Conceal rows from c, blend rows from b, the others from g."""
            return _sel(lost, c, _sel(blend, b, g))

        return {**state,
                "synth": merge(synthC, synthB, state["synth"]),
                "fnet": merge(fnetC, fnetB, state["fnet"]),
                "last_cond": merge(condC, condB, state["last_cond"]),
                "enc": new_enc,
                "plc_net": merge(plcC, plcB, plcG),
                "plc_copies": _sel(lost, copiesC, state["plc_copies"]),
                "feat_buf": _sel(lost, state["feat_buf"], featbufU),
                "feat_fill": torch.where(lost, 0, featfillU),
                "pcm_buf": _sel(lost, bufC, bufU),
                "pcm_fill": torch.where(lost, 0, fillU),
                "skip_analysis": torch.where(lost, skipC, skipU),
                "blend": lost,
                "features": merge(featuresC, predB, predG),
                "loss_count": torch.where(lost, lcC, 0),
                "fec_read": torch.where(lost, fecC["fec_read"], fec_readU),
                "fec_keep": torch.where(lost, fecC["fec_keep"], fec_keepU),
                "fec_skip": torch.where(lost, fecC["fec_skip"], fec_skipU),
                }, output


class NonCausalPLCEngine(_Engine):
    """Non-causal PLC with 5 ms lookahead (lpcnet_plc.c:349-492): output is
    delayed by TRAINING_OFFSET (80 samples), which lets the first good frame
    after a loss be blended with a TIME-REVERSED synthesis that meets the
    real audio halfway.

    Requires a no-lookahead model (FEATURES_DELAY == 0, enforced like the C
    at lpcnet_plc.c:356-361). Batched over streams with per-stream loss
    masks; every control path is computed for every stream and selected.

    remove_dc follows the C: DC is tracked/removed on input
    (lpcnet_plc.c:366-374), the blend path re-tracks it over the 5 ms
    concealment continuation and re-removes with the updated estimate
    (:389-399), concealed output re-adds the estimate through an 80-sample
    dc_buf delay line matched to the engine's output delay (:443-448,
    :477-489).

    Divergence from the C, as in the JAX package: the extractor state
    advances with batched chunk calls, so its pitch history is equivalent
    but not byte-identical."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.cfg.lookahead != 0:
            raise ValueError(
                "non-causal PLC needs a no-lookahead model "
                "(LPCNetConfig(lookahead=0)), cf. lpcnet_plc.c:356-361")

    @staticmethod
    def _default_cfg():
        return lpcnet_model.LPCNetConfig(lookahead=0)

    def init_state(self, batch: int) -> Dict[str, Any]:
        dev = self.device
        return {
            "synth": sample_scan.init_state(batch, self.cfg, device=dev),
            "fnet": lpcnet_model.frame_net_init_state(batch, self.cfg, dev),
            "enc": F.init_state(batch, dev),
            "plc_net": plc_model.init_net_state(batch, self.plc_cfg, dev),
            "features": self._zeros(batch, NB_TOTAL_FEATURES),
            "pcm_buf": self._zeros(batch, FRAME_SIZE),
            "queued": self._zeros(batch, dtype=torch.bool),
            "queued_samples": self._zeros(batch, FRAME_SIZE),
            "loss_count": self._zeros(batch, dtype=torch.int32),
            "dc_mem": self._zeros(batch),
            "syn_dc": self._zeros(batch),
            "dc_buf": self._zeros(batch, TRAINING_OFFSET),
        }

    def _cond(self, fstate, feats36):
        return lpcnet_model.frame_net_step(self.params, self.tables, fstate,
                                           feats36, self.cfg)

    def _plc(self, state, x):
        return plc_model.step(self.plc_params, state["plc_net"], x,
                              self.plc_cfg)

    @torch.no_grad()
    def step(self, state, pcm, lost):
        """One 10-ms frame per stream; output is the stream DELAYED by
        80 samples. pcm: (B, 160) (ignored where lost); lost: (B,) bool."""
        pcm, lost = self._f32(pcm), self._bool(lost)
        B = pcm.shape[0]
        cfg = self.cfg
        off = TRAINING_OFFSET
        buf = state["pcm_buf"]
        lc = state["loss_count"]
        dc = self.options.remove_dc

        # --- 0. queued teacher-forced catch-up (process_queued_update,
        # lpcnet_plc.c:342-347), first on every path
        fnetQ, condQ = self._cond(state["fnet"], state["features"])
        synthQ, _ = self._synth_samples(state["synth"], condQ, FRAME_SIZE,
                                        target=state["queued_samples"])
        synth = _sel(state["queued"], synthQ, state["synth"])
        fnet = _sel(state["queued"], fnetQ, state["fnet"])

        # --- DC removal on the incoming audio (update path only,
        # lpcnet_plc.c:366-374)
        if dc:
            delta0 = torch.trunc(state["syn_dc"])     # int delta = syn_dc
            mem_bak = state["dc_mem"] + state["syn_dc"]
            dc_mem1, lp1 = _dc_track(mem_bak, pcm)
            pcm1 = pcm - lp1
        else:
            pcm1 = pcm

        burg36 = burg_ops.burg_cepstral_analysis(pcm1)
        zeros20 = self._zeros(B, NB_FEATURES)
        one = torch.ones((B, 1), dtype=torch.float32, device=self.device)

        # ============ UPDATE path (good frame, lpcnet_plc.c:350-450)
        was_lost = lc > 0
        # --- blend sub-path: PLC pred on [burg36 | 0 | 1]
        plc_b, pred_b = self._plc(state,
                                  torch.cat([burg36, zeros20, one], dim=-1))
        feats_b = _pad36(pred_b)
        # pass 1: continue concealment for the buffered 5 ms (:386)
        fnet1, cond1 = self._cond(fnet, feats_b)
        synth1, tail_new = self._synth_samples(synth, cond1, off)
        buf_b = torch.cat([buf[:, :off], tail_new], dim=-1)
        # blend DC re-track: undo the initial removal, fold the synthesized
        # 5 ms into syn_dc, and re-remove with the updated estimate
        # (lpcnet_plc.c:389-399)
        if dc:
            syn_b = _dc_follow(self._zeros(B), tail_new)
            delta_b = torch.trunc(delta0 + syn_b)
            dc_mem_b, lp2 = _dc_track(mem_bak + syn_b, pcm)
            blend_row = (was_lost & ~lost)[:, None]
            pcm_rm = torch.where(blend_row, pcm - lp2, pcm1)
            lp_rm = torch.where(blend_row, lp2, lp1)
        else:
            delta_b = self._zeros(B)
            pcm_rm = pcm1
        # pass 2: time-reversed synthesis from cleared sample state
        # (:401-411)
        synth_clear = sample_scan.init_state(B, cfg, device=self.device)
        synth_clear["rng"] = synth1["rng"]     # keep the RNG stream moving
        _, cond2 = self._cond(fnet1, feats_b)
        synth2, _ = self._synth_samples(synth_clear, cond2, FRAME_SIZE,
                                        target=pcm_rm.flip(-1))
        _, rev_out = self._synth_samples(synth2, cond2, off)
        # raised-cosine cross-fade, reversed into the buffer tail (:407-411)
        w = _fade_window(self.device)
        mixed = w * buf_b[:, off:].flip(-1) \
            + (1 - w) * (rev_out + delta_b[:, None])
        buf_b = torch.cat([buf_b[:, :off],
                           torch.floor(0.5 + mixed).flip(-1)], dim=-1)
        # blend: the synth/frame states revert to the pre-pass copy (:414)
        # and the catch-up is queued for the next step (:415-418)
        queued_b = torch.cat([buf_b[:, off:], pcm_rm[:, :off]], dim=-1)
        # enc state advances over the blended previous frame (:421-424)
        encB, _, _ = F.compute_features(state["enc"], buf_b, mode="single")

        # --- shared: enc features of the incoming frame (:430-433)
        enc_in = _sel(lost | ~was_lost, state["enc"], encB)
        enc_upd, featsg, _ = F.compute_features(enc_in, pcm_rm,
                                                mode="single")
        featg36 = featsg[:, 0]

        # --- good sub-path (no preceding loss, :434-441)
        plc_g, pred_g = self._plc(
            state, torch.cat([burg36, featg36[:, :NB_FEATURES], one],
                             dim=-1))
        delayed = torch.cat([buf[:, off:], pcm_rm[:, :off]], dim=-1)
        fnetG, condG = self._cond(fnet, featg36)
        synthG, _ = self._synth_samples(synth, condG, FRAME_SIZE,
                                        target=delayed)

        # update-path results (blend output IS the queued catch-up buffer,
        # lpcnet_plc.c:415-418,441-444)
        out_upd = torch.where(was_lost[:, None], queued_b, delayed)
        if dc:
            # re-add the DC estimate through the 80-sample output delay
            # (lpcnet_plc.c:443-448)
            out_upd = out_upd + torch.cat([state["dc_buf"], lp_rm[:, :off]],
                                          dim=-1)
        synth_upd = _sel(was_lost, synth, synthG)   # blend keeps the copy
        fnet_upd = _sel(was_lost, fnet, fnetG)
        plc_upd = _sel(was_lost, plc_b, plc_g)
        feats_upd = torch.where(was_lost[:, None], feats_b, _pad36(pred_g))

        # ============ CONCEAL path (lost frame, lpcnet_plc.c:452-492)
        plc_c, pred_c = self._plc(
            state, self._zeros(B, plc_model.PLC_INPUT_SIZE))
        feats_c = _conceal_features(pred_c, _attenuation(lc))
        fnetC, condC = self._cond(fnet, feats_c)
        # first loss: teacher-force the buffered 5 ms then free-run
        # (:463-466)
        synthC1, outC1 = self._synth_samples(
            synth, condC, FRAME_SIZE,
            target=torch.cat([buf[:, off:], self._zeros(B, off)], dim=-1),
            preload=torch.full((B,), off, dtype=torch.int32,
                               device=self.device))
        buf_c1 = torch.cat([outC1[:, off:], buf[:, off:]], dim=-1)
        # repeated loss: free-run a full frame (:467-475)
        synthC2, outC2 = self._synth_samples(synth, condC, FRAME_SIZE)
        encC, _, _ = F.compute_features(
            state["enc"], torch.cat([buf[:, :off], outC2[:, :off]], dim=-1),
            mode="single")
        buf_c2 = torch.cat([outC2[:, off:], outC2[:, :off]], dim=-1)

        first = lc == 0
        out_con = torch.where(first[:, None], outC1, outC2)

        new_dc = {}
        if dc:
            # conceal DC handling (lpcnet_plc.c:477-489): track syn_dc on
            # the newly synthesized samples, re-add floor(.5+dc_mem)
            # through the dc_buf delay line
            dc_int = torch.floor(0.5 + state["dc_mem"])[:, None].repeat(
                1, off)
            track = torch.ones((B, FRAME_SIZE), dtype=torch.bool,
                               device=self.device)
            track[:, :off] = ~first[:, None]
            syn_con = _dc_follow(state["syn_dc"], out_con, track)
            out_con = out_con + torch.cat([state["dc_buf"], dc_int], dim=-1)
            new_dc = {
                "dc_mem": torch.where(
                    lost, state["dc_mem"],
                    torch.where(was_lost, dc_mem_b, dc_mem1)),
                "syn_dc": torch.where(lost, syn_con, 0.0),
                "dc_buf": torch.where(lost[:, None], dc_int,
                                      lp_rm[:, off:]),
            }

        # ============ merge paths
        return {**state,
                "synth": _sel(lost, _sel(first, synthC1, synthC2),
                              synth_upd),
                "fnet": _sel(lost, fnetC, fnet_upd),
                "enc": _sel(lost, _sel(first, state["enc"], encC), enc_upd),
                "plc_net": _sel(lost, plc_c, plc_upd),
                "features": torch.where(lost[:, None], feats_c, feats_upd),
                "pcm_buf": torch.where(
                    lost[:, None],
                    torch.where(first[:, None], buf_c1, buf_c2), pcm_rm),
                "queued": ~lost & was_lost,
                "queued_samples": torch.where(
                    lost[:, None], state["queued_samples"], queued_b),
                "loss_count": torch.where(lost, lc + 1, 0),
                **new_dc}, torch.where(lost[:, None], out_con, out_upd)
