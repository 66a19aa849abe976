"""The port's export to the reference C runtime (lpcnet_tpu_torch/utils/
export_ref.py) against the JAX package's (lpcnet_tpu/utils/export_ref.py)
on the shipped checkpoints: every blob and RDO-VAE statistics file byte
for byte, and the int8 blocks of the DOT_PROD emulation's quantize_tables
(lpcnet_tpu_torch/kernels/sample_dotprod.py) against the quantized export.
"""
import os

import numpy as np
import pytest
import torch

from lpcnet_tpu import cli as j_cli
from lpcnet_tpu.models import lpcnet as j_lm
from lpcnet_tpu.utils import export_ref as j_ex
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.kernels import sample_dotprod
from lpcnet_tpu_torch.models import lpcnet as t_lm
from lpcnet_tpu_torch.utils import export_ref as t_ex

HERE = os.path.dirname(__file__)
EXAMPLES = os.path.join(HERE, os.pardir, "examples")


@pytest.fixture(scope="module")
def models():
    """The three shipped checkpoints as the JAX package reads them (numpy
    trees) and as the port does (tensors on the CPU)."""
    lp = os.path.join(EXAMPLES, "speech_lpcnet_params.bin")
    pp = os.path.join(EXAMPLES, "speech_plc_params.bin")
    dp = os.path.join(EXAMPLES, "speech_dred_params.bin")
    j_dred, _ = j_cli.load_dred_model(dp)
    t_dred, _ = convert.load_dred(dp, device="cpu")
    return {"lpcnet": (j_cli.load_model_params(lp, None),
                       convert.load_lpcnet(lp, device="cpu")),
            "plc": (j_cli.load_model_params(pp, None),
                    convert.load_plc(pp, device="cpu")),
            "rdovae": (j_dred, t_dred)}


def _write(ex, name, params, path, flavour):
    if name == "lpcnet":
        cfg = (j_lm if ex is j_ex else t_lm).LPCNetConfig()
        ex.export_lpcnet_blob(params, cfg, path, quantize=flavour)
    elif name == "plc":
        ex.export_plc_blob(params, path, quantize=flavour)
    else:
        ex.export_rdovae_blob(params, path, include_stats=flavour)


@pytest.mark.parametrize("name,flavour", [
    ("lpcnet", False), ("lpcnet", True), ("plc", False), ("plc", True),
    ("rdovae", True), ("rdovae", False)])
def test_blob_is_byte_identical(models, tmp_path, name, flavour):
    """The blob of each shipped model, float and int8 (DOT_PROD) flavours,
    and the RDO-VAE's with and without its statistics: the same bytes."""
    j_params, t_params = models[name]
    _write(j_ex, name, j_params, str(tmp_path / "j.bin"), flavour)
    _write(t_ex, name, t_params, str(tmp_path / "t.bin"), flavour)
    j = (tmp_path / "j.bin").read_bytes()
    assert len(j) > 0 and (tmp_path / "t.bin").read_bytes() == j


def test_rdovae_stats_are_identical(models, tmp_path):
    """The q8/q10/q15 tables and the generated C sources of the shipped
    RDO-VAE: the same arrays and the same bytes."""
    j_params, t_params = models["rdovae"]
    js, ts = j_ex.export_rdovae_stats(j_params), \
        t_ex.export_rdovae_stats(t_params)
    assert list(js) == list(ts)
    for k in js:
        assert ts[k].dtype == js[k].dtype == np.uint16
        np.testing.assert_array_equal(ts[k], js[k])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j_ex.export_rdovae_stats_c(j_params, str(tmp_path / "j"))
    t_ex.export_rdovae_stats_c(t_params, str(tmp_path / "t"))
    for f in ("dred_rdovae_stats_data.h", "dred_rdovae_stats_data.c"):
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()


def test_helpers_match_on_a_sparse_matrix():
    """_sparse_blocks, _quantize_sparse_blocks and _quantize_dense_dotp on
    a matrix with whole zero blocks (which the export leaves out)."""
    rs = np.random.RandomState(3)
    A = rs.randn(16, 24).astype(np.float32) * 0.5
    A[4:8, 8:16] = 0.0
    A[12:16, :8] = 1e-12
    for fn in ("_sparse_blocks", "_quantize_sparse_blocks",
               "_quantize_dense_dotp"):
        jo, to = getattr(j_ex, fn)(A), getattr(t_ex, fn)(A)
        assert len(jo) == len(to)
        for a, b in zip(jo, to):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # band 0 drops its last block (32 x 1e-12 sums below 1e-10)
    assert t_ex._sparse_blocks(A)[1][:2].tolist() == [3, 0]


def _dense_from_qblocks(W, idx, n_in, n_out):
    """The int8 output-major 8x4 blocks of the quantized export back into
    an (inputs, outputs) matrix, zero where no block was kept."""
    A = np.zeros((n_in, n_out), np.int32)
    pos = w = 0
    for i in range(n_out // 8):
        nb = idx[pos]
        pos += 1
        for _ in range(nb):
            j = idx[pos]
            pos += 1
            A[j:j + 4, i * 8:(i + 1) * 8] = W[w:w + 32].reshape(8, 4).T
            w += 32
    return A


def test_dotprod_tables_equal_the_quantized_export(models):
    """quantize_tables' int8 matrices (GRU-A recurrent without its
    diagonal, GRU-B input and recurrent) and GRU-A's float diagonal are
    those of export_lpcnet_arrays(quantize=True) on the shipped vocoder,
    and so are its SU biases."""
    _, t_params = models["lpcnet"]
    cfg = t_lm.LPCNetConfig()
    na, nb = cfg.gru_a_units, cfg.gru_b_units
    arrays = t_ex.export_lpcnet_arrays(t_params, cfg, quantize=True)
    tables = t_lm.precompute_sample_tables(t_params, cfg)
    q = sample_dotprod.quantize_tables(tables, cfg, su_bias=True)
    qr_a = _dense_from_qblocks(arrays["sparse_gru_a_recurrent_weights"],
                               arrays["sparse_gru_a_recurrent_weights_idx"],
                               na, 3 * na)
    qi_b = _dense_from_qblocks(arrays["gru_b_weights"],
                               arrays["gru_b_weights_idx"], na, 3 * nb)
    qr_b = arrays["gru_b_recurrent_weights"].astype(np.int32).reshape(
        3 * nb // 8, nb // 4, 8, 4).transpose(1, 3, 0, 2).reshape(nb, 3 * nb)
    np.testing.assert_array_equal(q["qr_a"].numpy(), qr_a)
    np.testing.assert_array_equal(q["qi_b"].numpy(), qi_b)
    np.testing.assert_array_equal(q["qr_b"].numpy(), qr_b)
    np.testing.assert_array_equal(
        q["diag_a"].numpy(), arrays["sparse_gru_a_recurrent_weights_diag"])
    # the SU-bias compensation of both (and GRU-B's input half, which the
    # emulation adds apart as bi_b_extra)
    sub_a, sub_b = arrays["sparse_gru_a_subias"], arrays["gru_b_subias"]
    np.testing.assert_array_equal(q["br_a"].numpy(), sub_a[3 * na:])
    np.testing.assert_array_equal(q["br_b"].numpy(), sub_b[3 * nb:])
    np.testing.assert_array_equal(
        arrays["gru_b_bias"][:3 * nb] + q["bi_b_extra"].numpy(),
        sub_b[:3 * nb])
    assert isinstance(q["qr_a"], torch.Tensor)
