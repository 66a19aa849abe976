"""The port's graft entry (lpcnet_tpu_torch/graft_entry.py) against the JAX
package's __graft_entry__.py on the same inputs, against the port's own
Synthesizer, and its device rules; and the device-constant cache that lets
the step be captured as a CUDA graph."""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as j_lpcnet
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import convert, features, graft_entry, plc
from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan
from lpcnet_tpu_torch.ops import burg, dsp, mulaw, tables
from lpcnet_tpu_torch.vocoder import Synthesizer

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
FEATS = np.fromfile(os.path.join(os.path.dirname(__file__), "golden",
                                 "ref_feats.f32"), np.float32).reshape(-1, 36)
B = 4        # streams of the parity cases (ROADMAP section 3.4)


def _jax_entry():
    """JAX's (fn, example_args), from __graft_entry__.py at the repo root."""
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


@pytest.fixture(scope="module")
def jax_side():
    """JAX's entry, its fn jit-compiled as its __main__ does, and the port's
    entry on the CPU with the same weights (JAX's Synthesizer() draws them
    from init_params(PRNGKey(0)))."""
    fn, args = _jax_entry()
    tree = j_lpcnet.init_params(jax.random.PRNGKey(0),
                                j_lpcnet.LPCNetConfig())
    params = convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                       device="cpu")
    tfn, _ = graft_entry.entry(device="cpu", batch=B, params=params)
    return jax.jit(fn), args, tfn, tree


def _to_torch(state):
    """A JAX state as the port's: the same leaves, rng as int64."""
    return {k: torch.tensor(np.asarray(v, np.int64 if k == "rng" else None))
            for k, v in state.items()}


@pytest.mark.parametrize("inputs", ["jax_example", "golden_streams"])
def test_entry_matches_jax_entry(jax_side, inputs):
    """One frame through JAX's jitted fn and the port's fn (the plain loop
    on the CPU). jax_example: JAX's own example args, first B rows (zero
    features, the shared seed: the rows are alike); golden_streams: B
    streams with per-stream seeds, one frame of the golden features each
    at offsets drawn from a fixed seed. Gates of lpcnet_tpu/verify.py: rng
    exact, pcm exact fraction >= 0.95, correlation >= 0.999."""
    jfn, (jstate, jfeats), tfn, tree = jax_side
    if inputs == "jax_example":
        jstate = jax.tree.map(lambda x: x[:B], jstate)
        feats = np.asarray(jfeats[:B])
    else:
        offs = np.random.RandomState(11).randint(0, len(FEATS), B)
        feats = FEATS[offs][:, None]
        jstate = JSynthesizer(params=tree, backend="scan").reset(
            B, per_stream_rng=True)
    st_j, pcm_j = jfn(jstate, jax.numpy.asarray(feats))
    before = dict(sample_cuda.launches)
    st_t, pcm_t = tfn(_to_torch(jstate), torch.tensor(feats))
    assert sample_cuda.launches == before
    pcm_t, pcm_j = pcm_t.numpy(), np.asarray(pcm_j)
    assert pcm_t.shape == pcm_j.shape == (B, 160)
    rng_exact = np.array_equal(st_t["rng"].numpy(),
                               np.asarray(st_j["rng"]).astype(np.int64))
    exact = (pcm_t == pcm_j).mean()
    corr = np.corrcoef(pcm_t.ravel(), pcm_j.ravel())[0, 1]
    print(f"graft entry vs JAX ({inputs}, B={B}): rng exact {rng_exact}, "
          f"pcm exact fraction {exact:.6f}, corr {corr:.8f}, max |d| "
          f"{np.abs(pcm_t - pcm_j).max()}")
    assert rng_exact and exact >= 0.95 and corr >= 0.999, (exact, corr)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one intra-op thread while each test runs: the plain loop
    at B=32 issues many small operations just over the size torch splits
    over its thread pool, and with other test processes on the host's
    cores each split waits on contended threads (measured on an 8-core
    host with 6 busy processes: over 250 s against 8 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_equals_synthesizer():
    """entry's fn is Synthesizer.synthesize on the same state and features,
    bit for bit; the example args are JAX's shapes, B=32 x one frame of
    zero features."""
    fn, (state, feats) = graft_entry.entry(device="cpu")
    assert feats.shape == (32, 1, 36) and not feats.any()
    assert state["gru_a"].shape == (32, 384)
    voc = Synthesizer(device="cpu")
    st, pcm = voc.synthesize(state, feats)
    st_e, pcm_e = fn(state, feats)
    assert torch.equal(pcm_e, pcm) and pcm.shape == (32, 160)
    assert all(torch.equal(st_e[k], v) for k, v in st.items())


def test_entry_and_compile_step_need_a_card(monkeypatch):
    """entry() means the card and raises where there is none; compile_step
    raises on CPU arguments (no graphs there), never calling fn eagerly."""
    fn, args = graft_entry.entry(device="cpu", batch=1)
    calls = []
    with pytest.raises(RuntimeError, match="CUDA graph"):
        graft_entry.compile_step(lambda *a: calls.append(a), args)
    assert calls == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()


def test_dryrun_multichip_runs_both_dry_runs(monkeypatch):
    """dryrun_multichip(n) runs the training step's dry run, then stream-
    parallel synthesis's, each over n ranks (tests/test_torch_parallel.py
    runs the real ones on the CPU)."""
    calls = []
    for name in ("dryrun_training_step", "dryrun_inference_stream_dp"):
        monkeypatch.setattr(
            graft_entry.mesh, name,
            lambda n, name=name, **kw: calls.append((name, n, kw)) or name)
    out = graft_entry.dryrun_multichip(3, device="cpu")
    kw = {"device": "cpu"}
    assert calls == [("dryrun_training_step", 3, kw),
                     ("dryrun_inference_stream_dp", 3, kw)]
    assert out == {"train": "dryrun_training_step",
                   "inference": "dryrun_inference_stream_dp"}


def test_main_on_cpu_calls_the_step_eagerly(monkeypatch, capsys):
    """--device cpu: the step eagerly, then the dry runs on one CPU rank."""
    calls = []
    monkeypatch.setattr(graft_entry, "dryrun_multichip",
                        lambda n, **kw: calls.append((n, kw)))
    assert graft_entry.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "entry OK: pcm (32, 160), finite True; called eagerly" in out
    assert "dryrun_multichip OK" in out
    assert calls == [(1, {"device": torch.device("cpu")})]


# the numpy values of the constants the PLC, synthesis and DRED paths keep
# on the device, computed here as each module computes it
_NEW_CONSTANTS = {
    "_INTERP": (features, np.array(
        [0.026184, -0.098339, 0.369938, 0.837891, -0.184969, 0.070242,
         -0.020947], dtype=np.float32)),
    "ULAW2LIN_TABLE": (mulaw, mulaw._c_ulaw2lin_table()),
    "_BW": (burg, 0.995 ** np.arange(1, 17, dtype=np.float32)),
    "ATT_TABLE": (plc, np.array([0, 0, -.2, -.2, -.4, -.4, -.8, -.8, -1.6,
                                 -1.6], dtype=np.float32)),
    "SAMPLING_LOGIT_TABLE": (tables, tables._sampling_logit_table()),
    "NODE_LEVEL": (sample_scan, np.array(
        [0] + [n.bit_length() - 1 for n in range(1, 256)], np.int64)),
    "FLAT_SCORE_W": (sample_scan, None),
    "FLAT_TARGET_LEAF": (sample_scan, None),
}


def _flat_tables():
    """FLAT_SCORE_W and FLAT_TARGET_LEAF from their definition
    (sample_pallas.py:99-127), independently of the module's loop."""
    w = np.zeros((256, 256), np.float32)
    leaf = np.zeros((2, 256), np.float32)
    for c in range(256):
        bits = [(c >> (7 - b)) & 1 for b in range(8)]
        for b in range(8):
            w[(1 << b) + (c >> (8 - b)), c] = 2.0 * bits[b] - 1.0
        leaf[:, c] = sum(bits), c
    return {"FLAT_SCORE_W": w, "FLAT_TARGET_LEAF": leaf}


@pytest.mark.parametrize("const", ["DCT_TABLE", "BAND_INTERP", "COMPENSATION",
                                   "_LAG", "TANSIG_TABLE"]
                         + list(_NEW_CONSTANTS))
def test_device_constants_are_made_once(const):
    """The constants of the conditioning's DSP and activations, and those
    of the PLC, burg, feature, mu-law and sampling paths, are made on a
    device once and the same tensor is given on every later call, with the
    numpy constant's values and type; a per-gamma weighting array is made
    once per gamma."""
    if const in _NEW_CONSTANTS:
        module, want = _NEW_CONSTANTS[const]
        a = getattr(module, const)
        want = _flat_tables()[const] if want is None else want
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(a, want)
    else:
        a = getattr(dsp, const, None)
        a = getattr(tables, const) if a is None else a
    t = tables.device_constant(a, torch.device("cpu"))
    assert tables.device_constant(a, torch.device("cpu")) is t
    assert tables.device_constant(a, "cpu") is t
    assert t.dtype == torch.from_numpy(a).dtype and t.device.type == "cpu"
    if const not in _NEW_CONSTANTS:
        assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), a)
    g = dsp._gamma_powers(0.9)
    assert dsp._gamma_powers(0.9) is g
    np.testing.assert_array_equal(
        dsp.lpc_weighting(torch.ones(16), 0.9).numpy(),
        0.9 ** np.arange(1, 17, dtype=np.float32))
