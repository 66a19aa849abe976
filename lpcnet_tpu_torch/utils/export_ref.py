"""The port's parameters into the reference C runtime's weight blobs and
DRED statistics files (the port's copy of lpcnet_tpu/utils/export_ref.py;
byte for byte what it writes).

The inverse of training_tf2/dump_lpcnet.py: a DNNw blob whose array names
and layouts are what init_lpcnet_model expects (parse_lpcnet_weights.c:
115-221), for the float (DISABLE_DOT_PROD) path:

  gru_a_embed_{sig,pred,exc}_weights   E @ Wi slices   (dump_lpcnet.py:450-457)
  gru_a_dense_feature_{weights,bias}   cond part + input bias (:458-460)
  gru_b_dense_feature_{weights,bias}   cond part, zero bias   (:462-469)
  gru_b_{weights,weights_idx}          block-sparse input (first Na rows)
  gru_b_recurrent_weights, gru_b_{bias,subias}
  sparse_gru_a_recurrent_weights{,_diag,_idx}, sparse_gru_a_{bias,subias}
  dual_fc_{weights,bias,factor}        (units, ch, in) layout (mdense)
  feature_conv{1,2}_{weights,bias}, feature_dense{1,2}_{weights,bias}
  embed_pitch_weights

Block-sparse layout (printSparseVector, dump_lpcnet.py:85-121): for each
8-wide OUTPUT band, idx = [nblocks, in_pos0, in_pos1, ...] with 4-input x
8-output float blocks stored input-major (vec.h:347-404 reads w[k*8+r]).
kernels/sample_dotprod.py quantizes the same matrices for its emulation.

The parameter trees are the port's (tensors on any device, copied to the
host by convert.params_to_numpy); the arithmetic is numpy's, as in the JAX
package, so the bytes are its bytes.
"""
import os
from typing import Any, Dict

import numpy as np


def _flatten2(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten2(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _numpy_flat(params) -> Dict[str, np.ndarray]:
    """A parameter tree of tensors -> '/'-joined paths of numpy arrays."""
    from ..convert import params_to_numpy
    return _flatten2(params_to_numpy(params))


def _sparse_blocks(A: np.ndarray):
    """A: (inputs, outputs). Returns (float blocks flat, idx int32) in the
    reference layout. Every 4x8 block that is not (numerically) zero is
    kept."""
    N, M = A.shape
    if N % 4 or M % 8:
        raise ValueError(f"block-sparse export needs inputs % 4 and "
                         f"outputs % 8 == 0, not {A.shape}")
    W0 = []
    idx = []
    for i in range(M // 8):
        pos = len(idx)
        idx.append(-1)
        nb = 0
        for j in range(N // 4):
            block = A[j * 4:(j + 1) * 4, i * 8:(i + 1) * 8]
            if np.sum(np.abs(block)) > 1e-10:
                nb += 1
                idx.append(j * 4)
                W0.append(block.reshape(-1))       # input-major (4, 8)
        idx[pos] = nb
    W = np.concatenate(W0) if W0 else np.zeros((0,), np.float32)
    return W.astype(np.float32), np.asarray(idx, np.int32)


def _gru_bias6(bi: np.ndarray, br: np.ndarray) -> np.ndarray:
    return np.concatenate([bi, br]).astype(np.float32)


def _quantize_sparse_blocks(A: np.ndarray):
    """The int8 (DOT_PROD) twin of _sparse_blocks (printSparseVector,
    dump_lpcnet.py:85-122): the same blocks and idx, the entries
    round(128*A) clipped to [-128, 127], each 4x8 block stored
    output-major (qblock.T) as the 8x4 kernels read it (vec.h:274-305).
    Returns (W int8, idx int32, AQ the whole quantized matrix, for the
    SU-bias compensation)."""
    N, M = A.shape
    if N % 4 or M % 8:
        raise ValueError(f"block-sparse export needs inputs % 4 and "
                         f"outputs % 8 == 0, not {A.shape}")
    AQ = np.clip(np.round(A * 128.0), -128, 127).astype(np.int32)
    W = []
    idx = []
    for i in range(M // 8):
        pos = len(idx)
        idx.append(-1)
        nb = 0
        for j in range(N // 4):
            block = A[j * 4:(j + 1) * 4, i * 8:(i + 1) * 8]
            if np.sum(np.abs(block)) > 1e-10:
                nb += 1
                idx.append(j * 4)
                qblock = AQ[j * 4:(j + 1) * 4, i * 8:(i + 1) * 8]
                W.append(qblock.T.reshape(-1))
        idx[pos] = nb
    Wq = np.concatenate(W) if W else np.zeros((0,), np.int32)
    return Wq.astype(np.int8), np.asarray(idx, np.int32), AQ


def _quantize_dense_dotp(A: np.ndarray):
    """Int8 dense weights in the DOT_PROD 8x4 traversal order (printVector
    dotp=True, dump_lpcnet.py:57-61): (in, out) -> [out/8][in/4][8][4].
    Returns (W int8 flat, AQ (in, out) for the SU-bias compensation)."""
    N, M = A.shape
    AQ = np.clip(np.round(A * 128.0), -128, 127).astype(np.int32)
    v = AQ.reshape(N // 4, 4, M // 8, 8).transpose(2, 0, 3, 1)
    return v.reshape(-1).astype(np.int8), AQ


def export_lpcnet_arrays(params: Dict[str, Any], cfg,
                         quantize: bool = False) -> Dict[str, np.ndarray]:
    """Vocoder parameters (models/lpcnet.py layout) -> the reference's
    named arrays.

    quantize=True gives the int8 (DOT_PROD) flavour that stock reference
    builds load: GRU-A/B recurrent and GRU-B input weights as int8 qweight
    records at scale 128 with SU-bias compensation (dump_grub /
    dump_sparse_gru, dump_lpcnet.py:137-192). The float flavour needs a
    -DDISABLE_DOT_PROD build."""
    p = _numpy_flat(params)
    na, nb = cfg.gru_a_units, cfg.gru_b_units
    es = cfg.embed_sig_size
    E = p["embed_sig/e"]
    wi_a = p["gru_a/wi"]                      # (3*es + nc, 3na)
    arrays: Dict[str, np.ndarray] = {}

    arrays["gru_a_embed_sig_weights"] = (E @ wi_a[:es]).astype(np.float32)
    arrays["gru_a_embed_pred_weights"] = \
        (E @ wi_a[es:2 * es]).astype(np.float32)
    arrays["gru_a_embed_exc_weights"] = \
        (E @ wi_a[2 * es:3 * es]).astype(np.float32)
    arrays["gru_a_dense_feature_weights"] = \
        wi_a[3 * es:].astype(np.float32)
    arrays["gru_a_dense_feature_bias"] = p["gru_a/bi"].astype(np.float32)

    # sparse GRU-A recurrent: the diagonal per gate, blocks of the rest
    wr_a = p["gru_a/wr"].astype(np.float32).copy()     # (na, 3na)
    diag = np.concatenate([np.diag(wr_a[:, k * na:(k + 1) * na])
                           for k in range(3)])
    for k in range(3):
        sub = wr_a[:, k * na:(k + 1) * na]
        sub -= np.diag(np.diag(sub))
    bias6 = _gru_bias6(p["gru_a/bi"], p["gru_a/br"])
    if quantize:
        W, idx, AQ = _quantize_sparse_blocks(wr_a)
        subias = bias6.copy()
        # SU-bias compensation on the recurrent half (dump_lpcnet.py:140)
        subias[3 * na:] -= AQ.sum(axis=0) / 128.0
    else:
        W, idx = _sparse_blocks(wr_a)
        subias = bias6
    arrays["sparse_gru_a_recurrent_weights"] = W
    arrays["sparse_gru_a_recurrent_weights_idx"] = idx
    arrays["sparse_gru_a_recurrent_weights_diag"] = diag.astype(np.float32)
    arrays["sparse_gru_a_bias"] = bias6
    arrays["sparse_gru_a_subias"] = subias

    # GRU-B: sparse input over GRU-A's outputs, the cond part dense, the
    # recurrent dense
    wi_b = p["gru_b/wi"]                      # (na + nc, 3nb)
    bias6b = _gru_bias6(p["gru_b/bi"], p["gru_b/br"])
    if quantize:
        Wb, idxb, AQin = _quantize_sparse_blocks(
            wi_b[:na].astype(np.float32))
        Wrb, AQrec = _quantize_dense_dotp(p["gru_b/wr"].astype(np.float32))
        subias_b = bias6b.copy()
        # (dump_grub, dump_lpcnet.py:190-192)
        subias_b[:3 * nb] -= AQin.sum(axis=0) / 128.0
        subias_b[3 * nb:] -= AQrec.sum(axis=0) / 128.0
        arrays["gru_b_recurrent_weights"] = Wrb
    else:
        Wb, idxb = _sparse_blocks(wi_b[:na].astype(np.float32))
        subias_b = bias6b
        arrays["gru_b_recurrent_weights"] = \
            p["gru_b/wr"].astype(np.float32)
    arrays["gru_b_weights"] = Wb
    arrays["gru_b_weights_idx"] = idxb
    arrays["gru_b_bias"] = bias6b
    arrays["gru_b_subias"] = subias_b
    arrays["gru_b_dense_feature_weights"] = wi_b[na:].astype(np.float32)
    arrays["gru_b_dense_feature_bias"] = np.zeros(3 * nb, np.float32)

    # dual_fc: ours (2, nb, 256) -> (256, 2, nb) (mdense layout)
    arrays["dual_fc_weights"] = \
        p["dual_fc/w"].transpose(2, 0, 1).astype(np.float32)
    arrays["dual_fc_bias"] = p["dual_fc/b"].astype(np.float32)   # (2,256)
    arrays["dual_fc_factor"] = p["dual_fc/factor"].astype(np.float32)

    for name, ours in (("feature_conv1", "conv1"),
                       ("feature_conv2", "conv2"),
                       ("feature_dense1", "dense1"),
                       ("feature_dense2", "dense2")):
        arrays[f"{name}_weights"] = p[f"{ours}/w"].astype(np.float32)
        arrays[f"{name}_bias"] = p[f"{ours}/b"].astype(np.float32)
    arrays["embed_pitch_weights"] = p["embed_pitch/e"].astype(np.float32)
    return arrays


def export_plc_arrays(params: Dict[str, Any],
                      quantize: bool = False) -> Dict[str, np.ndarray]:
    """PLC-network parameters (models/plc.py) -> the reference's names
    (dump_plc.py): plc_dense1, plc_gru1, plc_gru2 (sparse input, dense
    recurrent), plc_out. quantize=True gives the int8 DOT_PROD flavour for
    stock builds (the arithmetic of export_lpcnet_arrays)."""
    p = _numpy_flat(params)
    arrays: Dict[str, np.ndarray] = {}
    arrays["plc_dense1_weights"] = p["dense1/w"].astype(np.float32)
    arrays["plc_dense1_bias"] = p["dense1/b"].astype(np.float32)
    for name in ("gru1", "gru2"):
        n = p[f"{name}/wr"].shape[0]
        bias6 = _gru_bias6(p[f"{name}/bi"], p[f"{name}/br"])
        if quantize:
            W, idx, AQin = _quantize_sparse_blocks(
                p[f"{name}/wi"].astype(np.float32))
            Wr, AQrec = _quantize_dense_dotp(
                p[f"{name}/wr"].astype(np.float32))
            subias = bias6.copy()
            subias[:3 * n] -= AQin.sum(axis=0) / 128.0
            subias[3 * n:] -= AQrec.sum(axis=0) / 128.0
        else:
            W, idx = _sparse_blocks(p[f"{name}/wi"].astype(np.float32))
            Wr = p[f"{name}/wr"].astype(np.float32)
            subias = bias6
        arrays[f"plc_{name}_weights"] = W
        arrays[f"plc_{name}_weights_idx"] = idx
        arrays[f"plc_{name}_recurrent_weights"] = Wr
        arrays[f"plc_{name}_bias"] = bias6
        arrays[f"plc_{name}_subias"] = subias
    arrays["plc_out_weights"] = p["out/w"].astype(np.float32)
    arrays["plc_out_bias"] = p["out/b"].astype(np.float32)
    return arrays


def _write_blob(arrays: Dict[str, np.ndarray], path: str) -> None:
    """Named arrays -> a DNNw blob: int32 and int8 arrays as they are,
    everything else as float32, each flattened (names of at most 43
    bytes, the record's field)."""
    from . import weights_io
    flat = {}
    for name, a in arrays.items():
        if len(name) > 43:
            raise ValueError(f"DNNw names hold 43 bytes: {name!r}")
        flat[name] = (a if a.dtype in (np.int32, np.int8)
                      else np.ascontiguousarray(a, np.float32)).reshape(-1)
    weights_io.write_blob(path, flat)


def export_lpcnet_blob(params: Dict[str, Any], cfg, path: str,
                       quantize: bool = False) -> None:
    """The blob lpcnet_load_model reads (lpcnet.c:202-210).
    quantize=True: the int8 qweight flavour for stock (DOT_PROD) builds."""
    _write_blob(export_lpcnet_arrays(params, cfg, quantize=quantize),
                      path)


def export_plc_blob(params: Dict[str, Any], path: str,
                    quantize: bool = False) -> None:
    """The blob lpcnet_plc_load_model reads (lpcnet_plc.c:94-96).
    quantize=True: the int8 flavour for stock builds."""
    _write_blob(export_plc_arrays(params, quantize=quantize), path)


def export_rdovae_arrays(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """RDO-VAE parameters (models/rdovae.py) -> the reference's names
    (dump_rdovae.py:154-258, keraslayerdump.py's conventions): denses
    enc_dense{1,3,5,7,8}, gdense{1,2}, GRUs enc_dense{2,4,6} (sparse
    input, dense recurrent), the conv bits_dense; the decoder mirrored,
    with state{1,2,3} and dec_final."""
    p = _numpy_flat(params)
    arrays: Dict[str, np.ndarray] = {}

    def dense(cname, ours):
        arrays[f"{cname}_weights"] = p[f"{ours}/w"].astype(np.float32)
        arrays[f"{cname}_bias"] = p[f"{ours}/b"].astype(np.float32)

    def gru(cname, ours):
        W, idx = _sparse_blocks(p[f"{ours}/wi"].astype(np.float32))
        arrays[f"{cname}_weights"] = W
        arrays[f"{cname}_weights_idx"] = idx
        arrays[f"{cname}_recurrent_weights"] = \
            p[f"{ours}/wr"].astype(np.float32)
        bias6 = _gru_bias6(p[f"{ours}/bi"], p[f"{ours}/br"])
        arrays[f"{cname}_bias"] = bias6
        arrays[f"{cname}_subias"] = bias6

    for i in (1, 3, 5, 7, 8):
        dense(f"enc_dense{i}", f"enc/dense{i}")
        dense(f"dec_dense{i}", f"dec/dense{i}")
    for i in (2, 4, 6):
        gru(f"enc_dense{i}", f"enc/gru{i}")
        gru(f"dec_dense{i}", f"dec/gru{i}")
    dense("gdense1", "enc/gdense1")
    dense("gdense2", "enc/gdense2")
    arrays["bits_dense_weights"] = p["enc/bits_conv/w"].astype(np.float32)
    arrays["bits_dense_bias"] = p["enc/bits_conv/b"].astype(np.float32)
    for i in (1, 2, 3):
        dense(f"state{i}", f"dec/state{i}")
    dense("dec_final", "dec/final")
    return arrays


def _softplus32(x: np.ndarray) -> np.ndarray:
    """Float32 softplus in its stable form (tf.math.softplus's)."""
    x = np.asarray(x, np.float32)
    return (np.log1p(np.exp(-np.abs(x))) + np.maximum(x, 0)) \
        .astype(np.float32)


def export_rdovae_stats(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The q8/q10/q15 tables of the statistical model, from the lambda
    quant embedding (dump_rdovae.py:110-145): the fixed-point quantizer
    scales, dead zones and entropy-model (r, p0) that the reference's DRED
    entropy coder reads through DRED_rdovae_get_*_pointer
    (dred_rdovae.c:118-136). uint16 arrays of levels*N entries each."""
    w = _numpy_flat(params["quant_embed"])["e"].astype(np.float32)
    levels, dim = w.shape
    N = dim // 6
    quant_scales = _softplus32(w[:, :N])
    dead_zone = np.float32(0.05) * _softplus32(w[:, N:2 * N])
    r = (1.0 / (1.0 + np.exp(-w[:, 5 * N:6 * N]))).astype(np.float32)
    p0 = (1.0 / (1.0 + np.exp(-w[:, 4 * N:5 * N]))).astype(np.float32)
    p0 = (1.0 - r ** (0.5 + 0.5 * p0)).astype(np.float32)
    return {
        "dred_quant_scales_q8":
            np.round(quant_scales * 2**8).astype(np.uint16).reshape(-1),
        "dred_dead_zone_q10":
            np.round(dead_zone * 2**10).astype(np.uint16).reshape(-1),
        "dred_r_q15": np.round(r * 2**15).astype(np.uint16).reshape(-1),
        "dred_p0_q15": np.round(p0 * 2**15).astype(np.uint16).reshape(-1),
    }


def export_rdovae_stats_c(params: Dict[str, Any], out_dir: str) -> None:
    """dred_rdovae_stats_data.{h,c} in out_dir: the generated C sources the
    reference build compiles in (dump_rdovae.py's dump_statistical_model),
    so that a trained RDO-VAE deploys into the reference runtime's
    entropy-coding side as well as its network side."""
    stats = export_rdovae_stats(params)
    n = next(iter(stats.values())).size
    with open(os.path.join(out_dir, "dred_rdovae_stats_data.h"), "w") as f:
        f.write("/* generated from a TPU-trained RDO-VAE checkpoint "
                "(dump_rdovae.py equivalent) */\n"
                "#ifndef DRED_RDOVAE_STATS_DATA_H\n"
                "#define DRED_RDOVAE_STATS_DATA_H\n"
                '#include "opus_types.h"\n\n')
        for name in stats:
            f.write(f"extern const opus_uint16 {name}[{n}];\n")
        f.write("\n#endif\n")
    with open(os.path.join(out_dir, "dred_rdovae_stats_data.c"), "w") as f:
        f.write("/* generated from a TPU-trained RDO-VAE checkpoint */\n"
                '#include "dred_rdovae_stats_data.h"\n\n')
        for name, a in stats.items():
            body = ",".join(str(int(v)) for v in a)
            f.write(f"const opus_uint16 {name}[{n}] = {{\n{body}\n}};\n\n")


def export_rdovae_blob(params: Dict[str, Any], path: str,
                       include_stats: bool = True) -> None:
    """The blob the reference DRED parity harness reads (tools/ref_dred).
    include_stats adds the q8/q10/q15 entropy-model tables (as int32
    records: the DNNw format carries f32, i32 and i8) beside the network's
    weights, so that one file carries the whole deployment."""
    arrays = export_rdovae_arrays(params)
    if include_stats:
        for name, a in export_rdovae_stats(params).items():
            arrays[name] = a.astype(np.int32)
    _write_blob(arrays, path)
