"""The JAX package's remaining jax.jit sites in the port, on the CPU: the
feature and codec steps of the commands, the data pipeline, the bench and
the tools (data.feature_step, data.codec_step), the
k-means updates (codec/vq_train.py), the tools' steps (fit_pade.step,
train_codebooks.feats_of, eval_plc.forward), temperature synthesis (its
conditioning jit and its sample step, a graphs.loop_step) and the
data-parallel step (parallel/mesh.dp_train_step).

Each site is a graphs.jit named after it, reached with tensors on the
caller's device; the caches key and evict as the JAX package's do
(lpcnet_tpu/data.py:96-106, :148-156); the restructured temperature loop
equals the eager one bit for bit; loop_step captures once and replays
(through a stand-in for the CUDA graph); a two-rank gloo world's step
stays eager and leaves rank 0's parameters on every rank. The captures
themselves need the card: tests/test_torch_cuda.py, -k jit_site.
Everything runs at small sizes on one torch thread."""
import contextlib
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch import data
from lpcnet_tpu_torch.utils import graphs

CODEBOOKS = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                         "codec_codebooks.bin")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy(monkeypatch, step):
    """The argument tuples of every call of the jit's fn (which still
    runs)."""
    seen, fn = [], step.fn

    def record(*args):
        seen.append(args)
        return fn(*args)

    monkeypatch.setattr(step, "fn", record)
    return seen


def _on_cpu(args) -> bool:
    """Every leaf a CPU tensor or a static value: no numpy array reaches
    the graphed call."""
    leaves = graphs.flatten(args)[0]
    return any(isinstance(x, torch.Tensor) for x in leaves) and all(
        x.device.type == "cpu" for x in leaves
        if isinstance(x, torch.Tensor)) and not any(
        isinstance(x, np.ndarray) for x in leaves)


def _pcm(frames, batch=1, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, frames * 160) * 3000).astype(np.float32)


def _codebooks():
    from lpcnet_tpu_torch.cli import load_codebooks
    return load_codebooks(CODEBOOKS, "cpu")


# ------------------------------------------------------------ the caches

def test_feature_step_is_one_jit_per_key():
    """One jit per (quantize, mode), made once and kept, named after its
    key (JAX's _feature_step_fn cache)."""
    a = data.feature_step(True)
    assert data.feature_step(True, "superframe") is a
    assert data.feature_step(1) is a
    others = {data.feature_step(False), data.feature_step(False, "single"),
              data.feature_step(True, "single")}
    assert len(others | {a}) == 4
    assert isinstance(a, graphs.jit)
    assert a.name == "data.feature_step(quantize=True, mode=superframe)"


def test_codec_step_holds_one_slot_per_kind():
    """A codec step per kind, keyed by the codebooks dict: the same dict
    gives the same jit, a new dict evicts the kind's old jit (and its
    graphs) and leaves the other kinds' slots as they are (JAX's
    single-slot cache of its encode step)."""
    cbs1, cbs2 = _codebooks(), _codebooks()
    enc1 = data.codec_step("encode_superframes", cbs1)
    dec1 = data.codec_step("decode_packets", cbs1)
    assert data.codec_step("encode_superframes", cbs1) is enc1
    assert enc1.name == "data.encode_superframes"
    enc2 = data.codec_step("encode_superframes", cbs2)
    assert enc2 is not enc1
    assert data._CODEC_STEPS["encode_superframes"] == (id(cbs2), enc2)
    assert data.codec_step("decode_packets", cbs1) is dec1
    assert data.codec_step("encode_superframes", cbs1) is not enc1
    with pytest.raises(ValueError, match="kind must be one of"):
        data.codec_step("encode", cbs1)


@pytest.mark.parametrize("kind", data.CODEC_KINDS)
def test_codec_steps_are_the_codec_functions(kind):
    """Each codec step computes codec.<kind> on its codebooks."""
    from lpcnet_tpu_torch import features as F
    from lpcnet_tpu_torch.codec import codec
    cbs = _codebooks()
    _, feats, sps = F.compute_features(
        F.init_state(2), torch.as_tensor(_pcm(8, 2)), quantize_pitch=True)
    mem = torch.zeros(2, 18)
    args = {"encode_superframes": (feats, mem, sps),
            "encode_superframe": (feats[:, :4], mem, sps[0])}
    bufs = codec.encode_superframes(cbs, feats, mem, sps)[0]
    args.update({"decode_packets": (bufs, mem),
                 "decode_packet": (bufs[:, 0], mem)})
    got = data.codec_step(kind, cbs)(*args[kind])
    want = getattr(codec, kind)(cbs, *args[kind])
    assert all(torch.equal(a, b) for a, b in
               zip(graphs.flatten(got)[0], graphs.flatten(want)[0]))


# ------------------------------------------ the callers reach the jits

def test_cli_feature_commands_call_the_feature_step(monkeypatch, tmp_path):
    """The features and encode commands and dump-data's test modes reach
    the feature step and the encode step through their jits, and btest
    Burg (one kernel launch on the card, no graph), one call per chunk,
    with tensors on the command's device."""
    from lpcnet_tpu_torch import cli
    from lpcnet_tpu_torch.ops import burg
    pcm = _pcm(72)[0].astype(np.int16)
    src = str(tmp_path / "in.pcm")
    pcm.tofile(src)
    cbs_path = str(CODEBOOKS)

    def out(name):
        return str(tmp_path / name)

    # 72 frames padded to two chunks of 64: two calls of each step
    runs = [
        (["features", src, out("f.f32")], {data.feature_step(False): 2}),
        (["encode", src, out("c.bin"), "--codebooks", cbs_path],
         {data.feature_step(True): 2}),
        (["dump-data", "btest", src, out("b.f32")],
         {data.feature_step(False, "single"): 2}),
        (["dump-data", "qtest", src, out("q.f32"), "--codebooks",
          cbs_path], {data.feature_step(True): 2}),
    ]
    for argv, want in runs:
        seen = {step: _spy(monkeypatch, step) for step in want}
        burg_calls, real_burg = [], burg.burg_cepstral_analysis

        def burg_spy(pcm, burg_calls=burg_calls, real_burg=real_burg):
            burg_calls.append((pcm,))
            return real_burg(pcm)

        monkeypatch.setattr(burg, "burg_cepstral_analysis", burg_spy)
        enc = []
        real = data.codec_step

        def codec_step(kind, cbs, enc=enc):
            step = real(kind, cbs)
            enc.append((step, _spy(monkeypatch, step)))
            return step

        monkeypatch.setattr(data, "codec_step", codec_step)
        assert cli.main(argv + ["--device", "cpu"]) == 0, argv
        for step, n in want.items():
            assert len(seen[step]) == n, (argv, step.name)
            assert all(_on_cpu(a) for a in seen[step]), argv
        assert len(burg_calls) == (2 if "btest" in argv else 0), argv
        assert all(_on_cpu(a) for a in burg_calls), argv
        if "encode" in argv or "qtest" in argv:
            (step, calls), = enc
            assert step.name == "data.encode_superframes"
            assert len(calls) == 2 and all(_on_cpu(a) for a in calls)
        monkeypatch.undo()


def test_training_features_call_the_jits(monkeypatch):
    """prepare_training_data's chunks go through the feature step, and
    with codebooks through the encode step (-qtrain)."""
    if data.native.get_lib() is None:
        pytest.skip("the augmenter needs the native library")
    cbs = _codebooks()
    feat = _spy(monkeypatch, data.feature_step(True))
    enc = _spy(monkeypatch, data.codec_step("encode_superframes", cbs))
    feats, _ = data.prepare_training_data(_pcm(16)[0], seed=1,
                                          quantize_codebooks=cbs,
                                          device="cpu")
    assert feats.shape == (16, 36)
    assert len(feat) == len(enc) == 1 and _on_cpu(feat[0] + enc[0])


def test_tools_call_their_jits(monkeypatch):
    """eval_lpcnet's features, train_codebooks' corpus and codec measure,
    eval_plc's forward and fit_pade's step go through their jits, named
    after the JAX tools' jitted functions."""
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.tools import (eval_lpcnet, eval_plc, fit_pade,
                                        train_codebooks)
    assert train_codebooks.feats_of.name == "train_codebooks.feats_of"
    assert eval_plc.forward.name == "eval_plc.forward"
    assert fit_pade.fit_step.name == "fit_pade.step"
    feat = _spy(monkeypatch, data.feature_step(False))
    f = eval_lpcnet.speech_features(_pcm(20)[0], torch.device("cpu"))
    assert f.shape == (1, 20, 36) and len(feat) == 1 and _on_cpu(feat[0])

    if data.native.get_lib() is not None:
        corpus = _spy(monkeypatch, train_codebooks.feats_of)
        c = train_codebooks.build_corpus(_pcm(8)[0], 3, 0, "cpu", batch=2)
        assert c.shape == (24, 36) and len(corpus) == 2
        assert all(_on_cpu(a) for a in corpus)
    cbs = {k: v.numpy() for k, v in _codebooks().items()}
    qfeat = _spy(monkeypatch, data.feature_step(True))
    real = data.codec_step
    steps = {}

    def codec_step(kind, cbs):
        steps[kind] = real(kind, cbs)
        return steps[kind]

    monkeypatch.setattr(data, "codec_step", codec_step)
    rms = train_codebooks.codec_rms(_pcm(8)[0], cbs, "cpu")
    assert np.isfinite(rms) and len(qfeat) == 1
    assert sorted(steps) == ["decode_packet", "encode_superframe"]

    fwd = _spy(monkeypatch, eval_plc.forward)
    x = np.zeros((1, 6, 57), np.float32)
    eval_plc.lost_l1(plc_model.init_params(torch.Generator().manual_seed(7)),
                     x, np.zeros((6, 20), np.float32), np.ones(6, bool),
                     torch.device("cpu"))
    assert len(fwd) == 1 and _on_cpu(fwd[0])

    fit = _spy(monkeypatch, fit_pade.fit_step)
    fit_pade.fit(2, verbose=False, device="cpu")
    assert len(fit) == 2 * len(fit_pade.STAGES) and all(
        _on_cpu(a) for a in fit)


def test_vq_train_loops_call_their_jits(monkeypatch):
    """kmeans' Lloyd passes and kmeans_multi's updates go through their
    jits with the corpus and the generator as arguments (the JAX
    package's jitted _lloyd_pass and upd, vq_train.py:73, :226)."""
    from lpcnet_tpu_torch.codec import vq_train
    assert vq_train.lloyd.name == "vq_train.lloyd"
    assert vq_train.multi_update.name == "vq_train.kmeans_multi.upd"
    lloyd = _spy(monkeypatch, vq_train.lloyd)
    upd = _spy(monkeypatch, vq_train.multi_update)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(200, 17, generator=gen)
    cb = vq_train.kmeans(gen, x, 8, iters=2, final_iters=3)
    assert cb.shape == (8, 17)
    # splits to 2, 4, 8 with 2 passes each, then 3
    assert len(lloyd) == 9 and all(a[1] is gen and a[2] is x for a in lloyd)
    t = torch.randn(100, 4, 18, generator=gen)
    cb = vq_train.kmeans_multi(gen, t, 16, iters=1, final_iters=2)
    assert cb.shape == (16, 18)
    assert len(upd) == 10 + 2 + 2 and all(a[2] is t and a[3] is True
                                          for a in upd)


def test_multi_assignment_sign_without_an_upload():
    """_assign_multi's sign is filled on the device (torch.where with the
    scalar): the same entries and signs as a brute-force search."""
    from lpcnet_tpu_torch.codec import vq_train
    gen = torch.Generator().manual_seed(3)
    t = torch.randn(50, 4, 18, generator=gen)
    cb = torch.randn(16, 18, generator=gen)
    e, s = vq_train._assign_multi(t, cb, True)
    d = torch.stack([((t[:, k % 4] - sg * cb[k]) ** 2).sum(-1)
                     for sg in (1.0, -1.0) for k in range(16)], dim=-1)
    best = torch.argmin(d, dim=-1)
    assert torch.equal(e, best % 16)
    assert torch.equal(s, torch.where(best < 16, 1.0, -1.0))


# ---------------------------------------------- temperature synthesis

def _tiny_synth():
    from lpcnet_tpu_torch.models import lpcnet
    from lpcnet_tpu_torch.vocoder import Synthesizer
    cfg = lpcnet.LPCNetConfig(gru_a_units=48, gru_b_units=8, cond_size=16)
    params = lpcnet.init_params(torch.Generator().manual_seed(0), cfg)
    return Synthesizer(cfg, params=params, device="cpu")


def _temp_features(batch, frames, seed):
    rs = np.random.RandomState(seed)
    f = (rs.randn(batch, frames, 36) * 0.3).astype(np.float32)
    f[..., 19] = rs.uniform(0, 1, (batch, frames))
    return f


@pytest.mark.parametrize("batch", [1, 3])
def test_temperature_loop_equals_the_eager_loop(batch):
    """The restructured temperature synthesis (conditioning jit, the
    sample step in place on static buffers, pcm written at a position held
    on the device) equals the plain loop's synthesize_frames(...,
    temp_exp=...) bit for bit over two calls that carry the state, and
    keeps one step and its buffers per batch size."""
    from lpcnet_tpu_torch.kernels import sample_scan
    v = _tiny_synth()
    st = st_ref = v.reset(batch, per_stream_rng=True)
    for seed in (0, 1):
        f = _temp_features(batch, 2, seed)
        st, pcm = v.synthesize_temperature(st, f)
        ft = torch.as_tensor(f)
        st_ref, pcm_ref = sample_scan.synthesize_frames(
            v.tables, st_ref, v.conditions(ft), v.cfg,
            temp_exp=torch.clamp(1.5 * ft[..., 19] - 0.5, min=0.0))
        assert torch.equal(pcm, pcm_ref)
        assert list(st) == list(st_ref)
        assert all(torch.equal(st[k], st_ref[k]) for k in st_ref)
    step = v._temp_steps[batch]
    assert list(v._temp_steps) == [batch]
    assert step.name == "Synthesizer.synthesize_temperature.sample_step"
    assert v._temp_conds.name == \
        "Synthesizer.synthesize_temperature.conditions"
    # the returned state does not alias the buffers
    assert all(st[k].data_ptr() != step.bufs[k].data_ptr() for k in st)
    assert v._temperature_step(st, v._temp_conds(torch.as_tensor(f))) is step


class _Capture:
    """Stands in for torch.cuda.CUDAGraph and torch.cuda.graph around a
    loop_step: the capture leaves the buffers as it found them (a real one
    runs nothing), and a replay runs fn on them."""

    def __init__(self, loop):
        self.captured = self.replays = 0
        outer = self

        class Graph:
            def replay(self):
                outer.replays += 1
                loop.fn(loop.bufs)

        @contextlib.contextmanager
        def graph(g):
            saved = {k: v.clone() for k, v in loop.bufs.items()}
            yield
            for k, v in saved.items():
                loop.bufs[k].copy_(v)
            outer.captured += 1

        self.Graph, self.graph = Graph, graph


def test_loop_step_captures_once_on_its_buffers(monkeypatch):
    """loop_step as it runs on the card, with the capture stood in: the
    first call runs fn eagerly, the second captures it on the buffers and
    replays it, later calls replay; the module counts one capture and a
    replay per call from the second; inside disabled() fn runs eagerly;
    and the buffers end as eager calls leave them."""
    monkeypatch.setattr(graphs, "_device",
                        lambda args, name: torch.device("cuda", 0))
    bufs = {"x": torch.zeros(3), "n": torch.zeros(1, dtype=torch.int64)}
    eager = []

    def fn(b):
        eager.append(int(b["n"]))
        b["x"].index_copy_(0, b["n"] % 3, b["x"][b["n"] % 3] + 1 + b["n"])
        b["n"].add_(1)

    name = "test.loop_step"
    loop = graphs.loop_step(fn, bufs, name)
    cap = _Capture(loop)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", cap.Graph)
    monkeypatch.setattr(torch.cuda, "graph", cap.graph)
    graphs.captures.clear()
    graphs.replays.clear()
    for _ in range(5):
        loop()
    assert graphs.CAPTURE_CALL == 2
    assert cap.captured == 1 and cap.replays == 4 and loop.replays == 4
    assert graphs.captures == {name: 1} and graphs.replays == {name: 4}
    # 5 steps: the eager one, the capture's (undone) and 4 replays
    assert eager == [0, 1, 1, 2, 3, 4] and int(bufs["n"]) == 5
    with graphs.disabled():
        loop()
    assert graphs.replays == {name: 4} and int(bufs["n"]) == 6
    ref = {"x": torch.zeros(3), "n": torch.zeros(1, dtype=torch.int64)}
    for _ in range(6):
        fn(ref)
    assert torch.equal(bufs["x"], ref["x"])


def test_loop_step_on_the_cpu_runs_eagerly():
    calls = []
    loop = graphs.loop_step(lambda b: calls.append(b["x"].add_(1)),
                            {"x": torch.zeros(2)}, "test.cpu_loop")
    for _ in range(3):
        loop()
    assert len(calls) == 3 and loop.graph is None and loop.calls == 0
    assert torch.equal(loop.bufs["x"], torch.full((2,), 3.0))


def test_loop_step_capture_failure_names_the_step(monkeypatch):
    """A capture that fails raises RuntimeError naming the step; nothing
    runs eagerly in its place."""
    monkeypatch.setattr(graphs, "_device",
                        lambda args, name: torch.device("cuda", 0))

    @contextlib.contextmanager
    def failing(g):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", failing)
    calls = []
    loop = graphs.loop_step(lambda b: calls.append(1),
                            {"x": torch.zeros(1)}, "test.failing")
    loop()
    with pytest.raises(RuntimeError, match="test.failing: the call could "
                                           "not be captured"):
        loop()
    assert calls == [1] and loop.graph is None


# ------------------------------------------------ the data-parallel step

def dp_worker(rank, world, device, steps):
    """One rank: `steps` dp_train_steps of a narrow LPCNet from the same
    parameters and noise seed on this rank's rows; whether each ran
    eagerly (graphs.disabled() inside the step), the captures, and the
    final parameters."""
    from lpcnet_tpu_torch.models import lpcnet
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.training import lpcnet_task
    torch.set_num_threads(1)
    cfg = lpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, cond_size=16,
                              embed_sig_size=8, embed_pitch_size=4)
    params = mesh.replicate(lpcnet.init_params(
        torch.Generator().manual_seed(0), cfg))
    opt = lpcnet_task.make_optimizer()
    st = opt.init(params)
    local = {k: torch.as_tensor(v) for k, v in mesh.shard_batch(
        mesh.dryrun_batch(2 * world, 1, cfg), rank, world).items()}
    noise = torch.Generator().manual_seed(1)
    seen = []
    fn = mesh._dp_step.fn

    def record(*args):
        seen.append(graphs.is_disabled())
        return fn(*args)

    mesh._dp_step.fn = record
    for _ in range(steps):
        params, st, metrics = mesh.dp_train_step(params, st, local, cfg, opt,
                                                 noise)
    return {"eager": seen, "captures": dict(graphs.captures),
            "params": params, "loss": float(metrics["loss"]),
            "backend": torch.distributed.get_backend()}


def test_dp_step_in_a_gloo_world_is_eager_and_equal_on_every_rank(
        monkeypatch):
    """dp_train_step is a jit entry point ("mesh.dp_train_step"); in a
    two-rank gloo world (whose collectives cannot be captured) every step
    runs eagerly, and after two steps every rank holds rank 0's
    parameters exactly."""
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.training import optim
    monkeypatch.setenv("OMP_NUM_THREADS", "1")       # the ranks inherit it
    assert isinstance(mesh._dp_step, graphs.jit)
    assert mesh._dp_step.name == "mesh.dp_train_step"
    out = mesh.spawn("test_torch_jit_sites:dp_worker", 2, ["cpu", "cpu"],
                     "gloo", [2], timeout=300,
                     pythonpath=[os.path.dirname(__file__)])
    assert [o["backend"] for o in out] == ["gloo", "gloo"]
    assert all(o["eager"] == [True, True] and not o["captures"] for o in out)
    assert np.isfinite(out[0]["loss"]) and out[0]["loss"] == out[1]["loss"]
    a, b = (optim.tree_leaves(o["params"]) for o in out)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dp_step_without_a_group_is_the_train_step():
    """With no process group (one process) the data-parallel step is the
    single-process train step, bit for bit, also after it was a group's:
    no collective runs, the metrics are the same."""
    from lpcnet_tpu_torch.models import lpcnet
    from lpcnet_tpu_torch.parallel import mesh
    from lpcnet_tpu_torch.training import lpcnet_task, optim
    cfg = lpcnet.LPCNetConfig(gru_a_units=32, gru_b_units=8, cond_size=16,
                              embed_sig_size=8, embed_pitch_size=4)
    params = lpcnet.init_params(torch.Generator().manual_seed(0), cfg)
    opt = lpcnet_task.make_optimizer()
    batch = {k: torch.as_tensor(v)
             for k, v in mesh.dryrun_batch(2, 1, cfg).items()}
    p1, s1, m1 = mesh.dp_train_step(params, opt.init(params), batch, cfg,
                                    opt, torch.Generator().manual_seed(1))
    p2, s2, m2 = lpcnet_task.train_step(params, opt.init(params), batch,
                                        cfg, opt,
                                        torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in
               zip(optim.tree_leaves(p1), optim.tree_leaves(p2)))
    assert all(torch.equal(m1[k], m2[k]) for k in m2)
