"""The port's inference tools (lpcnet_tpu_torch/cli.py: rdovae-encode,
rdovae-decode, fec-encode, plc-test, addlpc, dump-weights-blob) against
the JAX package's commands (lpcnet_tpu/cli.py) on the same input files,
the port with --device cpu.

Measured on the CPU (port against JAX): rdovae-encode symbols equal on
100%, states max |d| 0; rdovae-decode features 5.7e-6; fec-encode
features 5.7e-6, rates equal; plc-test 1.4e-6; addlpc 4.6e-6;
dump-weights-blob, save_params and write_blob byte-identical.
"""
import os

import numpy as np
import pytest

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu.utils import fec_packets as j_fec
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch.utils import weights_io as t_wio

HERE = os.path.dirname(__file__)
FEATS = os.path.join(HERE, "golden", "ref_feats.f32")
SPEECH = os.path.join(HERE, "golden", "speech.s16")
EXAMPLES = os.path.join(HERE, os.pardir, "examples")
GATE_SYMBOLS = 0.995    # a symbol can flip at a rounding tie (±1)


def _run(tmp_path, name, args):
    """Run one command of each CLI; returns (port's output, JAX's output)
    paths: the arguments' OUT is replaced by the two output names."""
    t_out, j_out = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
    t_args = [t_out if a == "OUT" else a for a in args]
    j_args = [j_out if a == "OUT" else a for a in args]
    assert t_cli.main(t_args + ["--device", "cpu"]) == 0
    assert j_cli.main(j_args) == 0
    return t_out, j_out


@pytest.fixture(scope="module")
def feats40(tmp_path_factory):
    """The first 40 frames of the golden reference features."""
    path = str(tmp_path_factory.mktemp("feats") / "f40.f32")
    np.fromfile(FEATS, np.float32)[:40 * 36].tofile(path)
    return path


def test_rdovae_encode_matches_jax(tmp_path, feats40):
    """Symbols >= 99.5% equal, all within 1; PVQ states within 1e-5."""
    t_out, j_out = _run(tmp_path, "lat.s16",
                        ["rdovae-encode", feats40, "OUT", "--quant", "7"])
    got, want = np.fromfile(t_out, np.int16), np.fromfile(j_out, np.int16)
    assert got.shape == want.shape == (10 * 80,)
    assert np.abs(got.astype(np.int32) - want).max() <= 1
    assert (got == want).mean() >= GATE_SYMBOLS
    np.testing.assert_allclose(np.fromfile(t_out + ".state", np.float32),
                               np.fromfile(j_out + ".state", np.float32),
                               rtol=0, atol=1e-5)


def test_rdovae_decode_matches_jax(tmp_path, feats40):
    """From the JAX command's latent file: features within 1e-4, the
    LPC columns 0."""
    lat = str(tmp_path / "lat.s16")
    assert j_cli.main(["rdovae-encode", feats40, lat]) == 0
    t_out, j_out = _run(tmp_path, "dec.f32", ["rdovae-decode", lat, "OUT"])
    got = np.fromfile(t_out, np.float32).reshape(-1, 36)
    want = np.fromfile(j_out, np.float32).reshape(-1, 36)
    assert got.shape == want.shape == (40, 36)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not got[:, 20:].any()


def test_fec_encode_matches_jax(tmp_path):
    """80 frames of the golden speech, 8-dframe payloads every second
    dframe: header and packet count identical, features within 1e-3, rates
    within 1%."""
    pcm = str(tmp_path / "in.s16")
    np.fromfile(SPEECH, np.int16)[:80 * 160].tofile(pcm)
    t_out, j_out = _run(tmp_path, "out.fec",
                        ["fec-encode", pcm, "OUT", "--num-redundancy", "8",
                         "--packets-per-fec", "2"])
    with open(t_out, "rb") as a, open(j_out, "rb") as b:
        assert a.read(14) == b.read(14)
    got, got_rates = j_fec.read_fec_packets(t_out)
    want, want_rates = j_fec.read_fec_packets(j_out)
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.shape == w.shape == (32, 36)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_rates, want_rates, rtol=0.01)


def test_plc_test_matches_jax(tmp_path):
    """Seeded [burg36|feat20|received] frames, about 30% not received, the
    shipped PLC weights (the JAX command's default is a random init):
    reconstructed features within 1e-5, received frames kept exactly."""
    rs = np.random.RandomState(11)
    data = rs.randn(50, 57).astype(np.float32)
    data[:, -1] = (rs.random_sample(50) > 0.3).astype(np.float32)
    inp = str(tmp_path / "in.f32")
    data.tofile(inp)
    t_out, j_out = _run(tmp_path, "plc.f32", [
        "plc-test", inp, "OUT", "--weights",
        os.path.join(EXAMPLES, "speech_plc_params.bin")])
    got = np.fromfile(t_out, np.float32).reshape(-1, 20)
    want = np.fromfile(j_out, np.float32).reshape(-1, 20)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kept = data[:, -1] == 1
    np.testing.assert_array_equal(got[kept], data[kept, 36:56])


def test_addlpc_matches_jax(tmp_path):
    """The golden features with their LPC columns zeroed: the LPC rebuilt
    within the tolerance of test_torch_ops.py::
    test_lpc_from_cepstrum_close (1e-4), the other columns unchanged."""
    feats = np.fromfile(FEATS, np.float32).reshape(-1, 36).copy()
    feats[:, 20:] = 0
    inp = str(tmp_path / "in.f32")
    feats.tofile(inp)
    t_out, j_out = _run(tmp_path, "lpc.f32", ["addlpc", inp, "OUT"])
    got = np.fromfile(t_out, np.float32).reshape(-1, 36)
    want = np.fromfile(j_out, np.float32).reshape(-1, 36)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[:, :20], feats[:, :20])
    assert np.abs(got[:, 20:]).max() > 0


def test_dump_weights_blob_byte_identical(tmp_path):
    """Two families, a save_params checkpoint and a training checkpoint:
    the same bytes as the JAX command; the port reads them back."""
    from lpcnet_tpu.utils import checkpoint as j_ckpt
    train = str(tmp_path / "train.bin")
    params = j_wio.load_params(os.path.join(EXAMPLES, "speech_plc_params.bin"))
    j_ckpt.save_training(train, params, {"m": np.ones(3, np.float32)}, 7,
                         {"epoch": 1})
    specs = [f"plc={os.path.join(EXAMPLES, 'speech_plc_params.bin')}",
             f"dred={train}"]
    t_out, j_out = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    assert t_cli.main(["dump-weights-blob", t_out] + specs) == 0
    assert j_cli.main(["dump-weights-blob", j_out] + specs) == 0
    with open(t_out, "rb") as a, open(j_out, "rb") as b:
        assert a.read() == b.read()
    raw = t_wio.read_blob(t_out)
    assert len(raw) == 2 * len(t_wio.flatten(params))


def test_save_params_and_write_blob_byte_identical(tmp_path):
    """save_params of the shipped codebooks and write_blob of every record
    type: the JAX package's bytes; sparse_to_dense equal to its."""
    tree = j_wio.load_params(os.path.join(EXAMPLES, "codec_codebooks.bin"))
    a, b = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    t_wio.save_params(a, tree)
    j_wio.save_params(b, tree)
    assert open(a, "rb").read() == open(b, "rb").read()
    recs = {"f": np.arange(5, dtype=np.float32),
            "i": np.arange(17, dtype=np.int32),
            "q": np.arange(-64, 64, dtype=np.int8).reshape(8, 16),
            "x" * 50: np.zeros(0, np.float32)}
    t_wio.write_blob(a, recs)
    j_wio.write_blob(b, recs)
    assert open(a, "rb").read() == open(b, "rb").read()
    rs = np.random.RandomState(3)
    idx = np.array([2, 0, 8, 1, 4, 3, 0, 4, 8], np.int32)
    w = rs.randn(6 * 32).astype(np.float32)
    np.testing.assert_array_equal(
        t_wio.sparse_to_dense(idx, w, 24, 12),
        j_wio.sparse_to_dense(idx, w, 24, 12))
