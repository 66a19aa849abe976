"""The sample loop's launch plans and their operands, on the CPU: which CTA
serves which streams (launch_plan), the repacked wr_a of plan L, the fused
dual-FC weight's staging map of K5, each plan's shared-memory layout
against the card's limit, and the ctypes twin of the kernels' argument
block against the header that defines it. The kernels themselves run only
on the card (tests/test_torch_cuda.py)."""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.kernels import sample_cuda, sample_scan

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lpcnet_tpu_torch", "csrc")
SMEM_LIMIT = 232448            # dynamic shared memory of one H100 block
NA, NB, NL, TILE = 384, 16, 256, 8
G3A, G3B, ORDER = 3 * NA, 3 * NB, 16
KSLICE, KPART = 48, 8


def _header(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize("max_clusters", range(1, 9))
def test_every_stream_is_served_once(max_clusters):
    """For B = 1..2048: under plan L the 16 CTAs of a cluster serve one
    tile of 8 streams, under plan T each CTA its own, a CTA past the batch
    none; the tiles cover every stream exactly once."""
    for batch in range(1, 2049):
        plan, cluster, tile, grid = sample_cuda.launch_plan(batch,
                                                            max_clusters)
        assert tile == TILE and grid % cluster == 0
        per_tile = cluster if plan == "L" else 1      # CTAs per tile
        tile_of_cta = np.arange(grid) // per_tile
        assert (tile_of_cta.reshape(-1, per_tile)
                == tile_of_cta[::per_tile, None]).all()
        first = tile_of_cta[::per_tile] * TILE        # each tile's streams
        served = (first[:, None] + np.arange(TILE)[None, :]).ravel()
        served = served[served < batch]
        assert np.array_equal(np.sort(served), np.arange(batch)), batch
        tiles = -(-batch // TILE)
        if plan == "L":
            assert cluster == sample_cuda.CLUSTER_L
            assert grid == tiles * cluster
        else:
            assert cluster == sample_cuda.CLUSTER_T
            assert tiles <= grid < tiles + cluster


@pytest.mark.parametrize("max_clusters", range(0, 9))
def test_plan_l_never_needs_more_clusters_than_the_card_runs(max_clusters):
    """Plan L exactly while its clusters fit at once (B <= 8 x count): it
    never runs in a second wave; beyond that, plan T."""
    for batch in range(1, 2049):
        plan, cluster, _, grid = sample_cuda.launch_plan(batch, max_clusters)
        fits = batch <= TILE * max_clusters
        assert (plan == "L") == fits
        if plan == "L":
            assert grid // cluster <= max_clusters
    with pytest.raises(ValueError):
        sample_cuda.launch_plan(0, max_clusters)


def test_repacked_wr_a_reassembles_exactly():
    """Plan L's slices, one contiguous block per CTA, hold every element
    of wr_a once: [r, g*24 + u, k] = wr_a[k, g*384 + 24 r + u]; built once
    per tables dict."""
    wr_a = torch.as_tensor(
        np.random.RandomState(0).randn(NA, G3A).astype(np.float32))
    tables = {"wr_a": wr_a}
    wr_a_l = sample_cuda.plan_operands(tables)["wr_a_l"]
    assert sample_cuda.plan_operands(tables)["wr_a_l"] is wr_a_l
    units = NA // sample_cuda.CLUSTER_L
    assert wr_a_l.shape == (sample_cuda.CLUSTER_L, 3 * units, NA)
    assert wr_a_l.is_contiguous()
    back = torch.empty_like(wr_a)
    for r in range(sample_cuda.CLUSTER_L):
        for cc in range(3 * units):
            g, u = divmod(cc, units)
            back[:, g * NA + r * units + u] = wr_a_l[r, cc]
    assert torch.equal(back, wr_a)


# the instances of the sample loop (enum Kind of csrc/sample_loop.cuh) and
# the buffers of the shared layout each one uses beyond the GRUs': the
# dual-FC weights and the logit tables, the logits, how many threshold
# buffers, the flat sampler's compare bytes
KINDS = {"FRAME": (True, True, 1, True), "FORCED": (True, True, 1, True),
         "FUSE": (True, True, 1, False), "OPT": (True, True, 2, False),
         "TEACHER": (False, False, 0, False)}


def _tail_bytes(kind):
    """The tail's buffers that `kind` uses, in bytes."""
    dfc, logits, thr, cmp_ = KINDS[kind]
    return ((2 * NB * NL + 4 * NL + 2 * NL) * 4 * dfc + TILE * NL * 4 * logits
            + thr * TILE * 8 * 4 + TILE * NL * cmp_)


def _plan_l_bytes():
    """Plan L's shared memory per CTA, buffer by buffer
    (csrc/sample_loop.cuh)."""
    units, kpad = NA // 16, NA + 4
    floats = (3 * units * kpad           # wr_a slice
              + 2 * TILE * kpad          # s_ha, double buffer
              + KSLICE * G3B             # wi_b slice
              + NB * G3B + G3B           # wr_b, br_b
              + 2 * NB * NL + 4 * NL     # dual-FC w, b, factor
              + 2 * NL                   # logit and ULAW2LIN tables
              + KPART * TILE * G3B       # slice partials
              + 3 * TILE * G3B + TILE * NB   # GRU-B cb, zrh, rec, h
              + TILE * NL + 2 * TILE * 8     # logits, thresholds [2]
              + 2 * TILE * ORDER
              + TILE * 4 + 2 * TILE)     # indices, exc, active counts
    return floats * 4 + TILE * NL + 4 * 8   # compares, 3 mbarriers + pad


def _plan_t_bytes():
    """Plan T's: the tile layout, the ring, its mbarriers."""
    tile = (NA * G3B + NB * G3B + G3B + 2 * NB * NL + 4 * NL + 2 * NL
            + NA * TILE + KPART * TILE * G3B + 3 * TILE * G3B + TILE * NB
            + TILE * NL + 2 * TILE * 8 + 2 * TILE * ORDER + TILE * 4
            + 2 * TILE) * 4 + TILE * NL
    rows, stages = 4, 4
    return tile + stages * rows * G3A * 4 + 2 * stages * 8


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("plan,mirror", [("L", _plan_l_bytes),
                                         ("T", _plan_t_bytes)])
def test_shared_memory_layout_fits_one_block(plan, mirror, kind):
    """Each plan's layout, summed here buffer by buffer, is what the
    header's static_assert states and fits the 232,448 B of one block;
    every instance takes its plan's one layout, which holds the tail's
    buffers that instance uses (K5 'opt' the second threshold buffer, K4
    none)."""
    src = _header("sample_loop.cuh")
    stated = int(re.search(rf"static_assert\({plan}_SMEM_BYTES == (\d+)",
                           src).group(1))
    assert mirror() == stated
    assert stated <= SMEM_LIMIT
    assert re.search(rf"\b{kind} = \d+,", src), kind
    full = _tail_bytes("OPT") + TILE * NL         # every tail buffer
    assert mirror() - full + _tail_bytes(kind) <= stated


def test_fused_dual_fc_staging_reassembles_dfc_w():
    """The index map by which the fused instances stage dfc_w12 (NB, 2*NL)
    = [w1 | w2] into the (2, NB, NL) layout the loop reads (fused_dfc_src
    of the header, evaluated here) gives back dfc_w exactly, element by
    element, from the operands sample_scan.fused_operands builds."""
    src = _header("sample_loop.cuh")
    expr = re.search(r"constexpr int fused_dfc_src\(int i\) \{\s*return "
                     r"(.*?);\s*\}", src, re.S).group(1)
    expr = " ".join(expr.split()).replace("/", "//")   # C int division
    rs = np.random.RandomState(1)
    w = torch.as_tensor(rs.randn(2, NB, NL).astype(np.float32))
    tables = {"dual_fc": {"w": w, "b": torch.zeros(2, NL)},
              **{k: torch.zeros(NL, G3A)
                 for k in ("tbl_sig", "tbl_pred", "tbl_exc")}}
    w12 = sample_scan.fused_operands(tables)["dfc_w12"].reshape(-1)
    idx = np.array([eval(expr, {"NB": NB, "NL": NL, "i": i})
                    for i in range(2 * NB * NL)])
    assert np.array_equal(np.sort(idx), np.arange(2 * NB * NL))
    assert torch.equal(w12[torch.as_tensor(idx)].reshape(2, NB, NL), w)


_CTYPES = {"float*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int*": ctypes.c_void_p,
           "long long*": ctypes.c_void_p, "unsigned long long*":
           ctypes.c_void_p, "long long": ctypes.c_longlong,
           "int": ctypes.c_int, "float": ctypes.c_float}


@pytest.mark.parametrize("library", sample_cuda.LIBRARIES)
def test_params_twin_matches_the_header(library):
    """Every launch entry of each library takes the one argument block,
    and _Params has the fields of LpcnetFrameParams in the header's order
    and types, so every offset and the size agree with the C layout."""
    source = _header(library + ".cu")
    entries = sample_cuda._ENTRIES[library]
    for fn in re.findall(r"^int (lpcnet_\w+)\(", source, re.M):
        assert fn in entries, fn
        if fn != "lpcnet_prepare_plans":
            assert re.search(rf"int {fn}\(const LpcnetFrameParams\* p,",
                             source), fn
            assert entries[fn][0] is ctypes.POINTER(sample_cuda._Params)
    assert "struct" not in source
    body = re.search(r"struct LpcnetFrameParams \{(.*?)\n\};",
                     _header("lpcnet_sample.cuh"), re.S).group(1)
    fields = []
    for line in body.split("\n"):
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        decl = decl.replace("const ", "")
        m = re.match(r"(.*?[\s*])(\w+(?:,\s*\w+)*)$", decl)
        ctype = m.group(1).replace(" *", "*").strip()
        for name in m.group(2).split(","):
            fields.append((name.strip(), _CTYPES[ctype]))

    class Mirror(ctypes.Structure):
        _fields_ = fields

    twin = sample_cuda._Params
    assert [f[0] for f in twin._fields_] == [f[0] for f in fields]
    for name, _ in fields:
        assert getattr(twin, name).offset == getattr(Mirror, name).offset, \
            name
        assert getattr(twin, name).size == getattr(Mirror, name).size, name
    assert ctypes.sizeof(twin) == ctypes.sizeof(Mirror)
