"""The spans inside the port's entry points and the records of a graph's
replay (lpcnet_tpu_torch/utils/profiling.py, utils/graphs.CompiledStep),
and the benchmark's metric files that read them (lpcbench/metrics/).

On the CPU (the sample loops stood in for): the spans' host ranges under
torch.profiler and their order; nothing entered, and the same bits, with
the profiler off; the bounded record of untraced replays, the traced
replay's ranges, and the span reads after untraced replays (through a
stand-in for the CUDA graph); each reader against a hand-filled
registry. Marked cuda, on the card: the event-record nodes a capture adds,
and the spans' device ms inside a replay. This file imports neither jax
nor lpcnet_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""
import collections
import contextlib
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.kernels import sample_cuda
from lpcnet_tpu_torch.models import lpcnet, plc as plc_model
from lpcnet_tpu_torch.plc import PLCEngine
from lpcnet_tpu_torch.utils import graphs, profiling
from lpcnet_tpu_torch.vocoder import Synthesizer

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)
SPEECH = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                  "speech.s16"), np.int16).astype(np.float32)
PLC_SPANS = ["burg", "features", "plc_net", "conditioning"]
# the metric files that read the spans, and the span each reads
SPAN_METRICS = {"cond_span_ms.frame": "conditioning",
                "cond_span_ms.rtf": "conditioning",
                "burg_span_ms.frame": "burg",
                "features_span_ms.frame": "features",
                "plc_net_span_ms.frame": "plc_net"}


@pytest.fixture(autouse=True)
def _fresh_records(monkeypatch):
    """Each test starts from empty span and replay records."""
    monkeypatch.setattr(profiling, "span_ms",
                        collections.defaultdict(float))
    monkeypatch.setattr(profiling, "span_calls", collections.Counter())
    monkeypatch.setattr(profiling, "replay_host", collections.defaultdict(
        functools.partial(collections.deque,
                          maxlen=profiling.REPLAY_RECORD)))


def _tiny(device="cpu", sizes=None):
    """A Synthesizer and a causal PLCEngine of random weights: narrow
    widths on the CPU (the plain sample loop), the published ones on the
    card (the CUDA kernels)."""
    gen = torch.Generator().manual_seed(0)
    if sizes is None:
        cfg, pcfg = lpcnet.LPCNetConfig(), plc_model.PLCConfig()
    else:
        cfg = lpcnet.LPCNetConfig(gru_a_units=96, cond_size=32)
        pcfg = plc_model.PLCConfig(dense_size=32, gru_size=48)
    lp, pp = lpcnet.init_params(gen, cfg), plc_model.init_params(gen, pcfg)
    return (Synthesizer(cfg, params=lp, device=device),
            PLCEngine(lp, pp, cfg, pcfg, device=device))


def _stand_in_frames(tables, state, conds, cfg, variant):
    """synthesize_frames without its sample loop: silence."""
    b, t = conds["lpc"].shape[:2]
    return state, conds["lpc"].new_zeros(b, t * cfg.frame_size)


def _stand_in_samples(synth_state, cond, nsamples, target=None, **kw):
    """PLCEngine._synth_samples without its sample loop: the target."""
    return synth_state, target[:, :nsamples].clone()


@pytest.fixture(scope="module")
def cpu_entry_points():
    """The CPU engines, their sample loops stood in for: the plain loop
    takes minutes on the CPU, and the spans lie outside it."""
    voc, engine = _tiny("cpu", sizes="narrow")
    with pytest.MonkeyPatch.context() as m:
        m.setattr(sample_cuda, "synthesize_frames", _stand_in_frames)
        m.setattr(engine, "_synth_samples", _stand_in_samples)
        yield voc, engine


def _plc_inputs(engine, frames=6, lost_at=(3, 4)):
    """A fresh state and `frames` (pcm, lost) pairs of one stream."""
    pcm = SPEECH[8000:8000 + 160 * frames].reshape(frames, 1, 160)
    lost = np.zeros((frames, 1), bool)
    lost[list(lost_at)] = True
    return engine.init_state(1), list(zip(pcm, lost))


def _ranges(prof, prefix):
    """(name, start us, end us) of the profiler's events named prefix...,
    in the order they started."""
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith(prefix)]
    return sorted(evs, key=lambda e: e[1])


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_synthesize_records_its_conditioning_span(cpu_entry_points):
    """Under a CPU profiler each Synthesizer.synthesize call holds one
    conditioning range, which ends before the call's sample loop."""
    voc, _ = cpu_entry_points
    state = voc.reset(1)
    with _cpu_profile() as prof:
        for k in range(2):
            state, _ = voc.synthesize(state, FEATS[None, 2 * k:2 * k + 2])
    spans = _ranges(prof, "lpcnet/")
    assert [s[0] for s in spans] == [
        "lpcnet/Synthesizer.synthesize/conditioning"] * 2
    assert spans[0][2] <= spans[1][1]


def test_plc_step_records_its_four_spans_in_order(cpu_entry_points):
    """Each PLCEngine.step call holds burg, features, plc_net and
    conditioning, in that order and without overlap, on good and lost
    frames alike."""
    _, engine = cpu_entry_points
    state, frames = _plc_inputs(engine, frames=5, lost_at=(3,))
    with _cpu_profile() as prof:
        for pcm, lost in frames:
            state, _ = engine.step(state, pcm, lost)
    spans = _ranges(prof, "lpcnet/")
    names = ["lpcnet/PLCEngine.step/" + n for n in PLC_SPANS]
    assert [s[0] for s in spans] == names * len(frames)
    for a, b in zip(spans, spans[1:]):
        assert a[1] <= a[2] <= b[1]


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered with the profiler off")


@pytest.mark.parametrize("entry", ["Synthesizer.synthesize",
                                   "PLCEngine.step"])
def test_profiler_off_enters_nothing_and_changes_no_bit(
        cpu_entry_points, monkeypatch, entry):
    """With the profiler off no record_function is entered; the outputs
    and the state are bit for bit those of the profiled calls."""
    voc, engine = cpu_entry_points
    if entry == "PLCEngine.step":
        state0, frames = _plc_inputs(engine)

        def calls():
            st, outs = state0, []
            for pcm, lost in frames:
                st, out = engine.step(st, pcm, lost)
                outs.append(out)
            return st, outs
    else:
        state0 = voc.reset(1, per_stream_rng=True)

        def calls():
            st, outs = state0, []
            for k in range(3):
                st, out = voc.synthesize(st, FEATS[None, 2 * k:2 * k + 2])
                outs.append(out)
            return st, outs
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _raise)
        m.setattr(torch.autograd.profiler, "record_function", _raise)
        off = calls()
    with _cpu_profile() as prof:
        on = calls()
    assert _ranges(prof, "lpcnet/" + entry)
    off_leaves, off_tree = graphs.flatten(off)
    on_leaves, on_tree = graphs.flatten(on)
    assert off_tree == on_tree
    for a, b in zip(off_leaves, on_leaves):
        assert torch.equal(a, b)


class _StandInGraph:
    """Stands in for a CUDA graph: replay() runs fn on the static inputs
    and writes the results into the static outputs."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        res = self.fn(*self.args)
        for dst, src in zip(graphs.flatten(self.out)[0],
                            graphs.flatten(res)[0]):
            dst.copy_(src)


class _FakeEvent:
    """A timing event at a fixed ms; done: whether it has completed. A
    wait on it fails the test."""

    def __init__(self, ms):
        self.ms, self.done = ms, True

    def synchronize(self):
        raise AssertionError("a replay waited on a span event")

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.ms - self.ms


def _stand_in_step(name, spans=()):
    fn = lambda x: (x * 2, x.sum())  # noqa: E731
    static = (torch.zeros(3),)
    out = fn(*static)
    return graphs.CompiledStep(_StandInGraph(fn, static, out), static, out,
                               name, spans=spans)


def test_replay_host_record_is_bounded_and_untraced_only(monkeypatch):
    """Untraced replays append (copy_in, launch, clone_out) host ms to
    their entry point's record, which keeps the newest REPLAY_RECORD;
    traced replays append nothing and open the three phases as ranges."""
    monkeypatch.setattr(profiling, "replay_host", collections.defaultdict(
        functools.partial(collections.deque, maxlen=5)))
    step = _stand_in_step("test.replay")
    x = torch.arange(3.0)
    for _ in range(7):
        y, s = step(x)
    assert torch.equal(y, 2 * x) and float(s) == 3.0
    rec = profiling.replay_host["test.replay"]
    assert len(rec) == 5
    assert all(len(r) == 3 and min(r) >= 0.0 for r in rec)
    before = list(rec)
    with _cpu_profile() as prof:
        for _ in range(3):
            step(x)
    assert list(profiling.replay_host["test.replay"]) == before
    names = [e[0] for e in _ranges(prof, "lpcnet/test.replay/")]
    assert names == ["lpcnet/test.replay/" + p for p in
                     ("copy_in", "launch", "clone_out")] * 3
    assert step.replays == 10 and graphs.replays["test.replay"] >= 10
    assert profiling.replay_host_ms() == [sum(r) for r in before]


def test_spans_are_read_after_untraced_replays_without_waiting(
        monkeypatch):
    """A call reads the spans of the untraced replay before it when that
    is the SPAN_READ_EVERY-th since the last read, or the call is traced,
    and never waits; a replay whose events have not completed, and a
    traced replay, are not read."""
    monkeypatch.setattr(profiling, "SPAN_READ_EVERY", 2)
    ev = [_FakeEvent(ms) for ms in (0.0, 1.5, 1.5, 4.0)]
    spans = [("a", ev[0], ev[1]), ("b", ev[2], ev[3])]
    step = _stand_in_step("test.spans", spans)
    x = torch.ones(3)
    step(x)
    step(x)
    assert profiling.span_ms_per_call("a") is None
    step(x)                          # reads the second replay
    assert profiling.span_calls["test.spans"] == 1
    ev[3].done = False
    step(x)
    step(x)                          # the fourth has not completed
    assert profiling.span_calls["test.spans"] == 1
    ev[3].done = True
    with _cpu_profile():
        step(x)                      # traced: reads the fifth
        step(x)
    step(x)                          # the traced replay before it: unread
    step(x)
    assert profiling.span_calls["test.spans"] == 2
    step(x)
    assert profiling.span_calls["test.spans"] == 3
    assert profiling.span_ms["test.spans", "a"] == 4.5
    assert profiling.span_ms_per_call("a") == 1.5
    assert profiling.span_ms_per_call("b") == 2.5
    assert profiling.span_ms_per_call("c") is None


def _reader(metric):
    path = os.path.join(ROOT, "lpcbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("m_" + metric, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS)
                         + ["replay_host_ms_p95.frame"])
def test_metric_reader_reads_the_registry(metric):
    """Each reader gives its per-call number from a hand-filled registry
    (the span's device ms over the calls read; the 95th percentile of the
    replays' host ms) and None from an empty one."""
    read = _reader(metric).read
    assert read(None) is None
    if metric in SPAN_METRICS:
        # 4 replays of one entry point read: 2 ms in the span each, and
        # another span that the reader leaves alone
        profiling.span_ms["E.step", SPAN_METRICS[metric]] = 8.0
        profiling.span_ms["E.step", "other"] = 100.0
        profiling.span_calls["E.step"] = 4
        assert read(None) == 2.0
    else:
        for k in range(1, 101):       # 1..100 ms over the three phases
            profiling.replay_host["E.step"].append((0.5 * k, 0.25 * k,
                                                    0.25 * k))
        assert read(None) == pytest.approx(95.05)


# --- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, no CPU mode)")
    return torch.device("cuda")


def _plc_args(engine, device):
    state = engine.init_state(1)
    pcm = torch.as_tensor(SPEECH[8000:8160][None], device=device)
    return state, pcm, torch.zeros(1, dtype=torch.bool, device=device)


@pytest.mark.cuda
def test_captured_plc_step_holds_the_span_event_nodes(card, monkeypatch):
    """A captured PLCEngine.step holds one event-record node per span
    boundary (its four spans are adjacent, so they share their inner
    boundaries: five events), and no other node more than the same
    capture without spans."""
    _, engine = _tiny(card)
    args = _plc_args(engine, card)
    step = graphs.compile_step(engine._step_impl, args, "PLCEngine.step",
                               keep_graph=True)
    assert [s[0] for s in step.spans] == PLC_SPANS
    for (_, _, end), (_, start, _) in zip(step.spans, step.spans[1:]):
        assert start is end
    events = {id(e) for s in step.spans for e in s[1:]}
    assert len(events) == len(PLC_SPANS) + 1
    with monkeypatch.context() as m:
        m.setattr(profiling, "span",
                  lambda name, joined=False: contextlib.nullcontext())
        bare = graphs.compile_step(engine._step_impl, args,
                                   "PLCEngine.step", keep_graph=True)
    assert bare.spans == []
    assert (graphs.graph_nodes(step.graph) - graphs.graph_nodes(bare.graph)
            == len(events))


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["Synthesizer.synthesize",
                                   "PLCEngine.step"])
def test_replayed_spans_time_inside_the_replay(card, entry, monkeypatch):
    """The spans of an untraced replay, read at the next call, are
    positive device ms whose sum is no more than the whole replay timed
    by CUDA events; a traced replay is neither read nor in the host
    record."""
    monkeypatch.setattr(profiling, "SPAN_READ_EVERY", 1)
    voc, engine = _tiny(card)
    if entry == "PLCEngine.step":
        args = _plc_args(engine, card)
        call, names = (lambda: engine.step(*args)), PLC_SPANS
    else:
        state = voc.reset(1)
        feats = torch.as_tensor(FEATS[None, :1], device=card)
        call, names = (lambda: voc.synthesize(state, feats)), [
            "conditioning"]
    for _ in range(4):              # eager, capture and replay, replays
        call()
        torch.cuda.synchronize()
    assert len(profiling.replay_host[entry]) == 3
    assert profiling.span_calls[entry] == 2   # the replays before the last
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    call()
    b.record()
    b.synchronize()
    profiling.span_ms.clear()
    profiling.span_calls.clear()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        call()                      # reads the timed replay's spans
        torch.cuda.synchronize()
    call()
    assert len(profiling.replay_host[entry]) == 5
    assert profiling.span_calls[entry] == 1
    ms = [profiling.span_ms[entry, n] for n in names]
    assert min(ms) > 0.0
    assert sum(ms) <= a.elapsed_time(b)
