"""The PyTorch port's tables, scalar ops, DSP and weight loading against the
JAX package on the same inputs (lpcnet_tpu_torch vs lpcnet_tpu)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu.ops import activations as j_act
from lpcnet_tpu.ops import dsp as j_dsp
from lpcnet_tpu.ops import kiss99 as j_kiss
from lpcnet_tpu.ops import mulaw as j_mulaw
from lpcnet_tpu.ops import tables as j_tables
from lpcnet_tpu.utils import weights_io as j_wio
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.ops import activations as t_act
from lpcnet_tpu_torch.ops import dsp as t_dsp
from lpcnet_tpu_torch.ops import kiss99 as t_kiss
from lpcnet_tpu_torch.ops import mulaw as t_mulaw
from lpcnet_tpu_torch.ops import tables as t_tables
from lpcnet_tpu_torch.utils import weights_io as t_wio

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
WEIGHTS = os.path.join(REPO, "examples", "speech_lpcnet_params.bin")


def _read(name, dtype=np.float32):
    return np.fromfile(os.path.join(GOLDEN, name), dtype=dtype)


# ------------------------------------------------------------ exact tables

@pytest.mark.parametrize("name", [
    "SAMPLING_LOGIT_TABLE", "DCT_TABLE", "COMPENSATION", "BAND_INTERP",
    "BAND_EDGE_SCALE", "TANSIG_TABLE", "HALF_WINDOW", "EBAND5MS"])
def test_tables_bit_exact(name):
    # exact: the same numpy builders, so the same bits and dtype
    a, b = getattr(j_tables, name), getattr(t_tables, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)


def test_ulaw2lin_table_exact():
    # exact: the C's double-exp expression rounded once, vs JAX and the C dump
    np.testing.assert_array_equal(t_mulaw.ULAW2LIN_TABLE,
                                  j_mulaw.ULAW2LIN_TABLE)
    np.testing.assert_array_equal(t_mulaw.ULAW2LIN_TABLE,
                                  _read("mulaw.bin")[4002:4258])
    got = t_mulaw.ulaw2lin(torch.arange(256, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, j_mulaw.ULAW2LIN_TABLE)


def test_lin2ulaw_dense_sweep_exact():
    # exact: the float32 bit trick one rounded op at a time; sweep covers 0,
    # -0, +-32767, +-32768 and values past the clip
    xs = np.concatenate([
        np.linspace(-40000, 40000, 400001, dtype=np.float32),
        np.float32([0.0, -0.0, 32767, -32767, 32768, -32768, 1e6, -1e6,
                    1e-30, -1e-30, 0.5, -0.5])])
    got = t_mulaw.lin2ulaw(torch.as_tensor(xs)).numpy()
    want = np.asarray(j_mulaw.lin2ulaw(jnp.asarray(xs)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    d = _read("mulaw.bin")
    np.testing.assert_array_equal(
        t_mulaw.lin2ulaw(torch.as_tensor(d[:2001])).numpy(),
        d[2001:4002].astype(np.int32))


# ------------------------------------------------------------------ kiss99

def _t_stream(seed, n):
    st = t_kiss.to_tensor(seed)
    out = []
    for _ in range(n):
        st, r = t_kiss.kiss99_next(st)
        out.append(r)
    return torch.stack(out).numpy(), st.numpy()


@pytest.mark.parametrize("seed,sl", [
    (b"LPCNet", slice(0, 256)), (b"LPCNet\x01\x00\x00\x00", slice(256, None))])
def test_kiss99_golden_stream_exact(seed, sl):
    # exact: uint32 arithmetic in int64 masked to 32 bits, vs the C dump
    want = _read("kiss99.bin", np.uint32)[sl]
    got, _ = _t_stream(t_kiss.seed_from_bytes(seed), len(want))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_kiss99_batched_matches_jax_exact():
    seed = t_kiss.batched_seed(5, per_stream=True)
    np.testing.assert_array_equal(seed, j_kiss.batched_seed(5,
                                                            per_stream=True))
    np.testing.assert_array_equal(t_kiss.batched_seed(3),
                                  j_kiss.batched_seed(3))
    got, st_t = _t_stream(seed, 40)
    st = jnp.asarray(seed)
    want = []
    for _ in range(40):
        st, r = j_kiss.kiss99_next(st)
        want.append(np.asarray(r))
    np.testing.assert_array_equal(got, np.stack(want).astype(np.int64))
    np.testing.assert_array_equal(st_t, np.asarray(st).astype(np.int64))


def test_kiss99_advance_equals_stepping():
    """The closed-form jump against n single steps, exact, on random
    states and on the edge states of each generator: all zeros, all ones,
    the multiply-with-carry moduli and their neighbours, the seeds that
    kiss99_srand avoids."""
    rs = np.random.RandomState(0)
    st = rs.randint(0, 2 ** 32, (64, 4), dtype=np.uint64).astype(np.int64)
    st[0] = 0
    st[1] = 2 ** 32 - 1
    st[2] = [36969 * 65536 - 1, 18000 * 65536 - 1, 1, 1]
    st[3] = [36969 * 65536, 18000 * 65536, 5, 7]
    st[4] = [0x9068FFFF, 0x464FFFFF, 3, 4]
    state = torch.as_tensor(st)
    stepped = state
    for n in range(330):
        if n in (0, 1, 2, 3, 4, 17, 160, 320, 329):
            assert torch.equal(t_kiss.kiss99_advance(state, n), stepped), n
        stepped, _ = t_kiss.kiss99_next(stepped)


# ------------------------------------------------------------- activations

@pytest.mark.parametrize("name", ["tanh", "sigmoid"])
@pytest.mark.parametrize("approx", [False, True])
def test_activations_close(name, approx):
    # 1e-6: float32 transcendentals of two libraries differ by an ulp or two
    x = np.concatenate([np.linspace(-12, 12, 4001, dtype=np.float32),
                        np.random.RandomState(0).randn(1000)
                        .astype(np.float32) * 3])
    got = t_act.get(name, approx)(torch.as_tensor(x)).numpy()
    want = np.asarray(j_act.get(name, approx)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --------------------------------------------------------------------- dsp

def test_levinson_close():
    # 1e-4: sums of 16 float32 products in another order
    rs = np.random.RandomState(1)
    sig = rs.randn(6, 400).astype(np.float32)
    sig[1] = np.sin(0.05 * np.arange(400))          # early exit (30 dB)
    ac = np.stack([[np.dot(s[:400 - k], s[k:]) for k in range(17)]
                   for s in sig]).astype(np.float32)
    ac[2] = 0.0                                     # ac[0] == 0 guard
    got = [t.numpy() for t in t_dsp.levinson(torch.as_tensor(ac))]
    want = [np.asarray(w) for w in j_dsp.levinson(jnp.asarray(ac))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    assert np.all(got[0][2] == 0)


def test_lpc_from_cepstrum_close():
    # 1e-4: FFT and matmul sums in another order
    feats = _read("ref_feats.f32").reshape(-1, 36)[::7]
    got = t_dsp.lpc_from_cepstrum(torch.as_tensor(feats[:, :18]))
    want = j_dsp.lpc_from_cepstrum(jnp.asarray(feats[:, :18]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------- weights

def test_read_blob_and_load_params_exact():
    raw_t, raw_j = t_wio.read_blob(WEIGHTS), j_wio.read_blob(WEIGHTS)
    assert raw_t.keys() == raw_j.keys()
    for k in raw_j:
        np.testing.assert_array_equal(raw_t[k], raw_j[k])
    pt, pj = t_wio.load_params(WEIGHTS), j_wio.load_params(WEIGHTS)
    flat_t = jax.tree_util.tree_leaves_with_path(pt)
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert [p for p, _ in flat_t] == [p for p, _ in flat_j]
    assert len(flat_j) == 21
    for (_, a), (_, b) in zip(flat_t, flat_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_round_trip():
    tree = j_wio.load_params(WEIGHTS)
    tp = convert.params_from_numpy(tree, "cpu")
    assert tp["gru_a"]["wr"].dtype == torch.float32
    assert tp["gru_a"]["wr"].is_contiguous()
    back = convert.params_to_numpy(tp)
    jax.tree.map(np.testing.assert_array_equal, back, tree)
    loaded = convert.load_lpcnet(device="cpu")
    jax.tree.map(np.testing.assert_array_equal,
                 convert.params_to_numpy(loaded), tree)


# ------------------------------------------------------------- import rules

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "lpcnet_tpu", "h5py")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for b in BLOCKED:
    for m in [m for m in sys.modules
              if m == b or m.startswith(b + ".")]:
        del sys.modules[m]
import lpcnet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lpcnet_tpu_torch.__path__,
                                               "lpcnet_tpu_torch.")
         if m.name != "lpcnet_tpu_torch.__main__"]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules
       if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_neither_jax_nor_lpcnet_tpu():
    """Every module of lpcnet_tpu_torch, and chip_smoke.py, imports with
    jax, lpcnet_tpu and h5py blocked (the prefix lpcnet_tpu also matches
    lpcnet_tpu_torch, so the block matches whole package names; the card's
    machine has no h5py, which only the .h5 readers import, when called)."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(REPO))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT],
                         capture_output=True, text=True, env=env,
                         cwd=os.path.abspath(REPO), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(out.stdout.strip().splitlines()[-1].split())
    assert len(names) >= 15
    # the DRED, tools, DOT_PROD, multi-GPU and tooling modules are among
    # those imported
    assert {"lpcnet_tpu_torch." + m for m in (
        "dred", "models.rdovae", "utils.fec_packets", "utils.import_torch",
        "utils.weights_io", "kernels.sample_dotprod", "cli", "parallel.mesh",
        "utils.import_keras", "utils.export_ref", "utils.profiling")} <= names
