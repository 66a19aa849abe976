"""The port's bench (lpcnet_tpu_torch/bench.py) against the repo's bench.py,
and the six small functions it brought over against the JAX package's, on
the CPU at small sizes.

bench.py's stages are never run here (their JAX compiles take minutes):
its metric names are read from its source with ast. The port's stages run
at a few streams and frames on the plain loops. The two documented
differences: the latency lines name the card's kernel path 'cuda' where
bench.py has 'pallas', and the utilization lines divide by the card's
float32 peak in a field named percent_fp32_peak (bench.py:
percent_bf16_peak of the v5e's 197e12); the duty-cycle line also carries
the window's device occupancy.
"""
import ast
import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpcnet_tpu import verify as j_verify
from lpcnet_tpu.models import layers as j_layers
from lpcnet_tpu.ops import activations as j_act
from lpcnet_tpu_torch import bench as t_bench
from lpcnet_tpu_torch import verify as t_verify
from lpcnet_tpu_torch.models import layers as t_layers
from lpcnet_tpu_torch.models import rdovae as t_rv
from lpcnet_tpu_torch.ops import activations as t_act
from lpcnet_tpu_torch.training import rdovae_task as t_rvt

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
BENCH_PY = os.path.join(REPO, "bench.py")
CPU = torch.device("cpu")
V5E_PEAK = 197e12       # bench.py's peak, passed to the port's functions


def _jax_bench():
    """bench.py as a module (its top level imports numpy only)."""
    spec = importlib.util.spec_from_file_location("jax_bench", BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metric_names(path: str, backends) -> set:
    """Every metric name bench.py can print: the first argument of each
    _rt call, the value of each "metric" key and keyword; f-strings are
    formatted over batch in (1, 8) and the given backends."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        vals = []
        if isinstance(node, ast.Call):
            if getattr(node.func, "id", None) == "_rt":
                vals.append(node.args[0])
            vals += [k.value for k in node.keywords if k.arg == "metric"]
        elif isinstance(node, ast.Dict):
            vals += [v for k, v in zip(node.keys, node.values)
                     if isinstance(k, ast.Constant) and k.value == "metric"]
        for v in vals:
            if isinstance(v, ast.Constant):
                names.add(v.value)
            elif isinstance(v, ast.JoinedStr):
                code = compile(ast.Expression(v), path, "eval")
                names |= {eval(code, {}, {"batch": b, "backend": be})
                          for b in (1, 8) for be in backends}
    return names


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Full-width step loops of small ops: intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------- helpers

def test_random_features_are_bench_py_bits():
    j = _jax_bench()._random_features(3, 5)
    t = t_bench._random_features(3, 5, CPU)
    assert t.dtype == torch.float32 and t.shape == (3, 5, 36)
    np.testing.assert_array_equal(t.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))


def test_speech_features_tile_the_golden_speech():
    """LPCNET_BENCH_REAL_FEATURES=1: whole superframes of the golden
    speech's features, repeated over the frames and the streams."""
    from lpcnet_tpu_torch import features as F
    f = t_bench._speech_features(2, 6, CPU)
    assert f.shape == (2, 6, 36)
    pcm = np.fromfile(t_bench.GOLDEN_SPEECH, np.int16).astype(np.float32)
    _, want, _ = F.compute_features(F.init_state(1, CPU),
                                    torch.as_tensor(pcm[None, :4 * 160]))
    torch.testing.assert_close(f[0, :4], want[0], rtol=0, atol=0)
    torch.testing.assert_close(f[:, 4:], f[:, :2], rtol=0, atol=0)
    torch.testing.assert_close(f[1], f[0], rtol=0, atol=0)


@pytest.mark.parametrize("extra", [None, {"batch": 7}])
def test_rt_line_is_bench_py_line(extra):
    assert (t_bench._rt("encode_rt_factor", 3.2, 0.0123, extra)
            == _jax_bench()._rt("encode_rt_factor", 3.2, 0.0123, extra))


@pytest.mark.parametrize("fail", [False, True])
def test_summary_line_is_jax_summary_line(fail):
    report = {"device": "NVIDIA H100 80GB HBM3",
              "config": {"batch": 4, "frames": 2},
              "flat_rng_exact": {"ok": True, "measured": "exact"},
              "flat_vs_scan": {"ok": not fail,
                               "measured": {"exact_frac": 0.97,
                                            "corr": 0.9995}},
              "ok": not fail}
    line = t_verify.summary_line(report)
    assert line == j_verify.summary_line(report)
    assert line["value"] == (0.0 if fail else 1.0)
    # the bench's verify line takes a report made before it
    assert t_bench.bench_verify(report) == line


def test_flops_lines_equal_bench_py_at_its_peak():
    """With bench.py's peak the port's lines are bench.py's, the peak's
    field renamed, but for what kernel_arithmetic_tflops counts: the CUDA
    kernels' own operations (the one-hot embedding products are row reads
    there and the sampler a scan), with bench.py's dense-equivalent count
    beside them. The duty-cycle line also carries the occupancy."""
    jb = _jax_bench()
    rt = 1234.5
    util = {"duty_cycle": 0.9123, "device_occupancy": 0.97,
            "busy_us_by_class": {"sample_t_kernel": 123.4}}

    def renamed(d):
        return {("percent_fp32_peak" if k == "percent_bf16_peak" else k): v
                for k, v in d.items()}

    assert (t_bench.model_flops_estimate(rt, V5E_PEAK)
            == renamed(jb.model_flops_estimate(rt)))
    t_lines = t_bench.kernel_utilization_lines(rt, util, V5E_PEAK)
    j_lines = [renamed(d) for d in jb.kernel_utilization_lines(rt, util)]
    assert t_lines[0].pop("device_occupancy") == 0.97
    assert t_lines[0] == j_lines[0]
    t_k, j_k = t_lines[1], j_lines[1]
    # bench.py's count (bench.py:320-322) as a labelled extra
    assert t_k.pop("dense_equivalent_tflops") == j_k["value"]
    assert t_bench.DENSE_KERNEL_FLOPS == 2 * 1420032
    # the CUDA kernels' count: 469,760 multiply-adds, chip_smoke.py's bound
    assert t_bench.KERNEL_FLOPS == t_bench.CFG_FLOPS == 2 * 469760
    own = t_bench.KERNEL_FLOPS * rt * 16000.0 / util["duty_cycle"]
    assert t_k["value"] == round(own / 1e12, 2)
    assert t_k["vs_baseline"] == t_k["percent_fp32_peak"] == round(
        100.0 * own / V5E_PEAK, 2)
    assert {k: v for k, v in t_k.items() if k not in (
        "value", "vs_baseline", "percent_fp32_peak", "note")} == {
        k: v for k, v in j_k.items() if k not in (
            "value", "vs_baseline", "percent_fp32_peak", "note")}
    assert t_bench.kernel_utilization_lines(rt, None) == []
    # the default peak is the card's float32 rate
    d = t_bench.model_flops_estimate(rt)
    assert d["percent_fp32_peak"] == round(
        100.0 * t_bench.CFG_FLOPS * rt * 16000.0 / 67e12, 3)
    k = t_bench.kernel_utilization_lines(rt, util)[1]
    assert k["percent_fp32_peak"] == round(100.0 * own / 67e12, 2)


# ---------------------------------------------------------------- stages

def test_stage_metric_names_are_bench_py_names():
    """Each stage at a tiny size on the plain path prints a name bench.py
    prints on its portable path; on the card the latency names take
    'cuda' where bench.py's kernel path has 'pallas'."""
    jax_cpu = _metric_names(BENCH_PY, ("scan",))
    jax_tpu = _metric_names(BENCH_PY, ("pallas",))
    lines = ([t_bench.bench_features(batch=2, frames=4, iters=1,
                                     device=CPU)]
             + t_bench.bench_codec(batch=2, n_sf=1, iters=1, device=CPU)
             + [t_bench.bench_plc(batch=2, frames=1, iters=1, device=CPU)]
             + t_bench.bench_dred(batch=1, frames=64, iters=1, device=CPU)
             + [t_bench.bench_train(batch=1, iters=1, device=CPU)]
             + t_bench.bench_latency(iters=1, device=CPU))
    names = [d["metric"] for d in lines]
    assert len(names) == len(set(names)) == 9
    assert set(names) <= jax_cpu
    for d in lines:
        assert np.isfinite(d["value"]) and d["value"] > 0, d
        assert {"metric", "value", "unit", "vs_baseline"} <= set(d)
    cuda = {t_bench.latency_metric(b, torch.device("cuda")) for b in (1, 8)}
    assert {n.replace("_cuda_", "_pallas_") for n in cuda} <= jax_tpu
    assert not cuda & jax_tpu
    # the headline's and the utilization lines' names (the verify line's
    # is summary_line's, held above)
    assert {"synthesis_rt_factor_per_chip", "synthesis_rt_factor_total",
            "model_flops_estimate", "sample_kernel_duty_cycle",
            "kernel_arithmetic_tflops"} <= jax_cpu


STAGES = (("bench_features", 1), ("bench_codec", 2), ("bench_plc", 1),
          ("bench_dred", 2), ("bench_train", 1), ("bench_latency", 2))


@pytest.fixture
def stub_stages(monkeypatch):
    """Every stage but the headline stubbed; the headline runs for real at
    B=2 x 1 frame."""
    def stub(name, k):
        def fn(device=None, iters=None):
            out = [{"metric": f"{name}_{i}", "iters": iters}
                   for i in range(k)]
            return out if k == 2 else out[0]
        return fn

    for name, k in STAGES:
        monkeypatch.setattr(t_bench, name, stub(name, k))
    monkeypatch.setenv("LPCNET_BENCH_BATCH", "2")
    monkeypatch.setenv("LPCNET_BENCH_FRAMES", "1")
    monkeypatch.setenv("LPCNET_BENCH_ITERS", "1")


def test_main_prints_stages_in_bench_py_order_and_headline_last(
        stub_stages, monkeypatch, capsys):
    """main's order: stage lines, then (on the CPU no verify)
    model_flops_estimate, the headline last."""
    lines = t_bench.main(["--device", "cpu"], iters=2)
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert printed == lines
    assert [d["metric"] for d in lines] == [
        "bench_features_0", "bench_codec_0", "bench_codec_1",
        "bench_plc_0", "bench_dred_0", "bench_dred_1", "bench_train_0",
        "bench_latency_0", "bench_latency_1", "model_flops_estimate",
        "synthesis_rt_factor_per_chip"]
    # iters reaches the throughput stages, not the latency stage
    assert [d["iters"] for d in lines[:9]] == [2] * 7 + [None] * 2
    head = lines[-1]
    assert head["unit"] == "x_realtime" and head["value"] > 0
    # LPCNET_BENCH_STAGES=none: the headline alone
    monkeypatch.setenv("LPCNET_BENCH_STAGES", "none")
    assert [d["metric"] for d in t_bench.main(["--device", "cpu"])] == [
        "synthesis_rt_factor_per_chip"]


def test_main_runs_each_stage_inside_on_stage(stub_stages):
    """on_stage(name) wraps each stage's run, and only that run: a line
    prints after its stage has left the context."""
    log = []

    @contextlib.contextmanager
    def on_stage(name):
        log.append(("enter", name))
        yield
        log.append(("exit", name))

    lines = t_bench.main(["--device", "cpu"], on_stage=on_stage)
    names = [n for n, _ in STAGES] + ["bench_synthesis"]
    assert log == [(e, n) for n in names for e in ("enter", "exit")]
    assert len(lines) == 11
    # --verify: the verify stage alone, on the report given
    log.clear()
    report = {"device": "cpu", "config": {}, "ok": True}
    got = t_bench.main(["--verify", "--device", "cpu"], report=report,
                       on_stage=on_stage)
    assert got == [t_verify.summary_line(report)]
    assert log == [("enter", "bench_verify"), ("exit", "bench_verify")]


def test_multi_device_headline_needs_the_card(monkeypatch):
    monkeypatch.setenv("LPCNET_BENCH_DEVICES", "all")
    with pytest.raises(ValueError, match="card"):
        t_bench.bench_synthesis(CPU)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main([])


# ------------------------------------------------------ the small functions

def test_lpcnet_exp2_and_exp_are_jax_bits():
    x = np.linspace(-20, 20, 40001, dtype=np.float32)
    for t_fn, j_fn in ((t_act.lpcnet_exp2, j_act.lpcnet_exp2),
                       (t_act.lpcnet_exp, j_act.lpcnet_exp)):
        got = t_fn(torch.as_tensor(x)).numpy()
        want = np.asarray(j_fn(jnp.asarray(x)))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # below 2^-50 the bit trick gives 0
    assert float(t_act.lpcnet_exp2(torch.tensor(-60.0))) == 0.0


@pytest.mark.parametrize("approx", [False, True])
def test_gru_precomputed_apply_and_dualfc_logits_match_jax(approx):
    rs = np.random.RandomState(11)
    n, B = 24, 5
    gru = {"wr": rs.randn(n, 3 * n).astype(np.float32) * 0.3,
           "br": rs.randn(3 * n).astype(np.float32) * 0.1}
    h = rs.randn(B, n).astype(np.float32) * 0.5
    zrh = rs.randn(B, 3 * n).astype(np.float32)
    want = np.asarray(j_layers.gru_precomputed_apply(
        jax.tree.map(jnp.asarray, gru), jnp.asarray(h), jnp.asarray(zrh),
        approx=approx))
    got = t_layers.gru_precomputed_apply(
        {k: torch.as_tensor(v) for k, v in gru.items()}, torch.as_tensor(h),
        torch.as_tensor(zrh), approx=approx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dfc = {"w": rs.randn(2, 16, 256).astype(np.float32) * 0.3,
           "b": rs.randn(2, 256).astype(np.float32) * 0.1,
           "factor": 1 + 0.01 * rs.randn(2, 256).astype(np.float32)}
    x = rs.randn(3, 4, 16).astype(np.float32)
    want = np.asarray(j_layers.dualfc_logits(
        jax.tree.map(jnp.asarray, dfc), jnp.asarray(x), approx=approx))
    got = t_layers.dualfc_logits(
        {k: torch.as_tensor(v) for k, v in dfc.items()}, torch.as_tensor(x),
        approx=approx).numpy()
    assert got.shape == (3, 4, 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_noise_quantize_and_its_draw_in_rdovae_task():
    x = torch.linspace(-3, 3, 4 * 6 * 80).reshape(4, 6, 80)
    y = t_rv.noise_quantize(torch.Generator().manual_seed(3), x)
    assert y.shape == x.shape and y.dtype == torch.float32
    d = y - x
    assert float(d.min()) >= -0.5 - 1e-6 and float(d.max()) < 0.5 + 1e-6
    assert float(d.std()) > 0.25          # U(-.5, .5): std 0.289
    # rdovae_task.forward draws its noise through noise_quantize: a
    # generator gives the forward of the same draw passed in as a tensor
    cfg = t_rv.RDOVAEConfig(cond_size=32, cond_size2=32)
    params = t_rv.init_params(torch.Generator().manual_seed(0), cfg)
    rs = np.random.RandomState(2)
    feats = torch.as_tensor(rs.randn(2, 16, 20).astype(np.float32) * 0.3)
    qid = torch.as_tensor(rs.randint(0, 16, (2, 8)))
    with torch.no_grad():
        out_g = t_rvt.forward(params, feats, qid,
                              torch.Generator().manual_seed(5), cfg)
        noise = t_rv.noise_quantize(torch.Generator().manual_seed(5),
                                    torch.zeros((2, 8, 80)))
        out_t = t_rvt.forward(params, feats, qid, noise, cfg)
    for k in ("combined", "unquant", "dze"):
        torch.testing.assert_close(out_g[k], out_t[k], rtol=0, atol=0)
