"""The port's 1.6 kb/s codec (lpcnet_tpu_torch/codec: packet.py, vq.py,
codec.py) and its `features` and `encode` commands against the JAX
package's on the same inputs: seeded numpy arrays, the golden speech and
the shipped codebooks (examples/codec_codebooks.bin). Integer results
(packets, indices, fields) exact; each float tolerance is stated where it
is checked."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu.codec import codec as j_codec
from lpcnet_tpu.codec import packet as j_packet
from lpcnet_tpu.codec import vq as j_vq
from lpcnet_tpu.constants import FRAME_SIZE, NB_BANDS
from lpcnet_tpu.data import _feature_step_fn
from lpcnet_tpu.features import init_state as j_init_state
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import cli as t_cli
from lpcnet_tpu_torch import features as t_feat
from lpcnet_tpu_torch.codec import codec as t_codec
from lpcnet_tpu_torch.codec import packet as t_packet
from lpcnet_tpu_torch.codec import vq as t_vq

HERE = os.path.dirname(__file__)
SPEECH_PATH = os.path.join(HERE, "golden", "speech.s16")
SPEECH = np.fromfile(SPEECH_PATH, np.int16).astype(np.float32)
CODEBOOKS = j_wio.load_params(os.path.join(HERE, os.pardir, "examples",
                                           "codec_codebooks.bin"))
CB_J = {k: jnp.asarray(v) for k, v in CODEBOOKS.items()}
CB_T = {k: torch.as_tensor(v) for k, v in CODEBOOKS.items()}
# the JAX-vs-C codec gates (tests/test_codec_parity.py)
GATE_PACKETS, GATE_BYTES = 0.90, 0.95


def _t(x):
    return torch.as_tensor(np.array(x))


def _fields(rs, shape):
    return {name: rs.randint(0, 1 << width, shape).astype(np.int32)
            for name, width in j_packet.FIELDS}


def test_packet_pack_unpack_match_jax():
    """Seeded fields of every width: the same bytes MSB-first, and unpack
    gives the fields back, both exact."""
    assert t_packet.FIELDS == j_packet.FIELDS
    fields = _fields(np.random.RandomState(0), (5, 7))
    want = np.asarray(j_packet.pack({k: jnp.asarray(v)
                                     for k, v in fields.items()}))
    got = t_packet.pack({k: _t(v) for k, v in fields.items()})
    assert got.dtype == torch.uint8 and got.shape == (5, 7, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    back = t_packet.unpack(got)
    jback = j_packet.unpack(jnp.asarray(want))
    for name, _ in t_packet.FIELDS:
        np.testing.assert_array_equal(back[name].numpy(), fields[name])
        np.testing.assert_array_equal(back[name].numpy(),
                                      np.asarray(jback[name]))


def _vq_inputs(rs, n=13):
    """Cepstrum-scale vectors and the shipped codebooks."""
    return {"x17": (rs.randn(n, 17) * 0.8).astype(np.float32),
            "f": [(rs.randn(n, NB_BANDS) * 0.8).astype(np.float32)
                  for _ in range(5)],
            "ids": rs.randint(0, 8, n).astype(np.int32),
            "idx3": rs.randint(0, 3, n).astype(np.int32)}


def _vq_cases(inp):
    """name -> (args for JAX, the same for the port)."""
    f0, f1, f2, f3, mem = inp["f"]
    cb1, cb2, cb3, d4 = (CODEBOOKS[k] for k in ("cb1", "cb2", "cb3",
                                                "diff4"))
    return {
        "_dists": (inp["x17"], cb1),
        "vq_nearest": (cb2, inp["x17"]),
        "quantize_3stage_mbest": (inp["x17"], cb1, cb2, cb3),
        "_interp_preds": (f0, f1),
        "quantize_diff": (f1, mem, f3, d4),
        "interp_search": (f0, mem, f1),
        "double_interp_search": (f0, f1, f2, f3, mem),
        "single_interp": (f0, f1, inp["idx3"]),
        "perform_double_interp": (f0, f1, f2, f3, mem, inp["ids"]),
    }


@pytest.mark.parametrize("name", sorted(_vq_cases(_vq_inputs(
    np.random.RandomState(0)))))
def test_vq_function_matches_jax(name):
    """Each quantizer function on seeded inputs and the shipped codebooks:
    integer outputs (indices, entries, ids) exact, float outputs
    (reconstructions, distances) to 1e-6 of their scale (the distance
    product sums in another order)."""
    args = _vq_cases(_vq_inputs(np.random.RandomState(7)))[name]
    want = getattr(j_vq, name)(*map(jnp.asarray, args))
    got = getattr(t_vq, name)(*map(_t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                       atol=1e-6 * max(1.0, np.abs(w).max()))


def test_topk_min_keeps_ties_in_index_order():
    """Equal distances come out in index order, as jax.lax.top_k's do
    (the C merge's stable order), and the k smallest are JAX's."""
    d = np.array([[3.0, 1.0, 2.0, 1.0, 1.0, 0.5, 2.0, 1.0],
                  [1.0] * 8], np.float32)
    for k in (1, 3, 5):
        jv, ji = j_vq._topk_min(jnp.asarray(d), k)
        tv, ti = t_vq._topk_min(torch.as_tensor(d), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        t_vq._topk_min(torch.as_tensor(d), 5)[1].numpy(),
        [[5, 1, 3, 4, 7], [0, 1, 2, 3, 4]])


@pytest.fixture(scope="module")
def jax_superframes():
    """JAX superframe features with quantized pitch of the first 64 frames
    of the speech and of a copy shifted by 1000 samples, through the JAX
    command's jitted step."""
    x = np.stack([SPEECH[:64 * FRAME_SIZE],
                  SPEECH[1000:1000 + 64 * FRAME_SIZE]])
    _, feats, sps = _feature_step_fn(True)(j_init_state(2), jnp.asarray(x))
    return x, feats, sps


def test_encode_and_decode_given_the_same_features_match_jax(
        jax_superframes):
    """Both encoders on JAX's quantized features and superframe dicts:
    byte-identical packets (32 of them), the quantized features to 1e-5
    (LPC from the cepstrum, FFT sums in another order) and the final
    vq_mem to 1e-6. Both decoders on those packets: the same features, the
    cepstrum to 1e-6 and the pitch features to 1e-5 (pow in another
    library). The port's encode_superframes equals its sequential
    encode_superframe calls byte for byte."""
    _, feats, sps = jax_superframes
    mem = np.zeros((2, NB_BANDS), np.float32)
    bj, fqj, mj = jax.jit(lambda f, m, s: j_codec.encode_superframes(
        CB_J, f, m, s))(feats, jnp.asarray(mem), sps)
    sps_t = [{k: _t(v) for k, v in sp.items()} for sp in sps]
    bt, fqt, mt = t_codec.encode_superframes(CB_T, _t(feats), _t(mem),
                                             sps_t)
    bj, bt = np.asarray(bj), bt.numpy()
    assert bt.shape == (2, 16, 8) and bt.dtype == np.uint8
    if not np.array_equal(bt, bj):
        bad = np.argwhere((bt != bj).any(-1))
        raise AssertionError(f"packets differ at (stream, superframe) "
                             f"{bad.tolist()}")
    np.testing.assert_allclose(fqt.numpy(), np.asarray(fqj), atol=1e-5)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)

    m = _t(mem)
    seq = []
    for g, sp in enumerate(sps_t):
        b, _, m = t_codec.encode_superframe(CB_T, _t(feats)[:, 4 * g:4 * g
                                                             + 4], m, sp)
        seq.append(b)
    assert torch.equal(torch.stack(seq, dim=1), torch.as_tensor(bt))

    dj, _ = j_codec.decode_packets(CB_J, jnp.asarray(bj), jnp.asarray(mem))
    dt, _ = t_codec.decode_packets(CB_T, _t(bj), _t(mem))
    dj, dt = np.asarray(dj), dt.numpy()
    assert dt.shape == (2, 64, 36)
    np.testing.assert_allclose(dt[..., :NB_BANDS], dj[..., :NB_BANDS],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt[..., NB_BANDS:], dj[..., NB_BANDS:],
                               rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def jax_encode(tmp_path_factory):
    """The JAX encode command on the golden speech (50 packets)."""
    out = tmp_path_factory.mktemp("encode") / "jax.bin"
    assert j_cli.main(["encode", SPEECH_PATH, str(out)]) == 0
    return np.fromfile(out, np.uint8).reshape(-1, 8)


def test_encode_command_is_byte_identical_to_jax(jax_encode, tmp_path):
    """The port's `encode --device cpu` on the golden speech: the JAX
    command's 400 bytes exactly (both chunk the speech into padded
    64-frame calls)."""
    out = tmp_path / "port.bin"
    assert t_cli.main(["encode", SPEECH_PATH, str(out), "--device",
                       "cpu"]) == 0
    got = np.fromfile(out, np.uint8).reshape(-1, 8)
    assert jax_encode.shape == (50, 8)
    np.testing.assert_array_equal(got, jax_encode)


def test_pcm_to_packets_meets_the_codec_gates(jax_encode):
    """pcm -> packets, each package on its own features: the port in ONE
    call over the 200 frames (no chunks) against the JAX command's
    packets, with the JAX-vs-C gates: whole packets >= 0.90 and bytes
    >= 0.95. Measured: 1.0 and 1.0 (50 of 50 packets)."""
    x = torch.as_tensor(SPEECH[None, :200 * FRAME_SIZE].copy())
    _, feats, sps = t_feat.compute_features(t_feat.init_state(1), x,
                                            quantize_pitch=True)
    bufs, _, _ = t_codec.encode_superframes(CB_T, feats,
                                            torch.zeros((1, NB_BANDS)), sps)
    got = bufs[0].numpy()
    packets = float((got == jax_encode).all(-1).mean())
    byts = float((got == jax_encode).mean())
    print(f"whole packets equal {packets:.4f}, bytes equal {byts:.4f}")
    assert packets >= GATE_PACKETS and byts >= GATE_BYTES, (packets, byts)


def test_features_command_matches_jax(tmp_path):
    """`features --quantize-pitch` of both packages on 100 frames and a
    few samples (25 superframes, two padded chunks): cepstrum and LPC to
    1e-4, pitch and correlation features to 1e-5, the bounds of the
    superframe mode's parity test."""
    src = tmp_path / "in.s16"
    SPEECH[:100 * FRAME_SIZE + 37].astype(np.int16).tofile(src)
    for main, name, extra in ((j_cli.main, "jax.f32", []),
                              (t_cli.main, "port.f32", ["--device", "cpu"])):
        assert main(["features", str(src), str(tmp_path / name),
                     "--quantize-pitch"] + extra) == 0
    want = np.fromfile(tmp_path / "jax.f32", np.float32).reshape(-1, 36)
    got = np.fromfile(tmp_path / "port.f32", np.float32).reshape(-1, 36)
    assert got.shape == want.shape == (100, 36)
    np.testing.assert_allclose(got[:, :NB_BANDS], want[:, :NB_BANDS],
                               atol=1e-4)
    np.testing.assert_allclose(got[:, 20:], want[:, 20:], atol=1e-4)
    np.testing.assert_allclose(got[:, 18:20], want[:, 18:20], atol=1e-5)


def test_default_codebooks_come_from_the_generator():
    """Placeholder codebooks of the shipped shapes, the same for the same
    generator seed and others for another."""
    a = t_codec.default_codebooks(torch.Generator().manual_seed(0))
    b = t_codec.default_codebooks(torch.Generator().manual_seed(0))
    c = t_codec.default_codebooks(torch.Generator().manual_seed(1))
    for k, v in CODEBOOKS.items():
        assert a[k].shape == v.shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
