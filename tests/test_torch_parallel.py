"""The port's multi-GPU module (lpcnet_tpu_torch/parallel/mesh.py) on the
CPU: 2-rank gloo worlds in subprocesses (mesh.spawn), against one process
of the port and against the JAX package's shard_synthesis on the conftest's
8-device CPU mesh.

Gates: stream-parallel synthesis gathered equals one Synthesizer run on the
whole batch exactly; against JAX, pcm within 1 on <= 1% of the samples
(ROADMAP.md §3.3: a float near-tie of floor(.5 + x)). The flagship DP
training step (B=4, T=2): both ranks' parameters exactly equal; the loss
within 1e-5 (relative) of the single-process step on the whole batch; the
gradients the ranks average within 1e-4 of each leaf's largest entry of
the whole batch's; the step's parameters exactly Adam's update on those
averaged gradients (what the all-reduce feeds it). Adam's first step
divides each gradient entry by its own magnitude (g / (|g| + 1e-8)), so an
entry with |g| near 1e-8 turns a 1e-7-relative difference of the gradient
into a visible one of the update: the updated parameters of the DP and
single-process steps differ by up to 1.24e-4 of gru_a/wi's largest entry
(the CPU, B=4, T=2), with the gradients 1.3e-6 apart.
"""
import jax
import numpy as np
import pytest
import torch

from lpcnet_tpu.models import lpcnet as j_lm
from lpcnet_tpu.parallel import mesh as j_mesh
from lpcnet_tpu.vocoder import Synthesizer as JSynthesizer
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import lpcnet as t_lm
from lpcnet_tpu_torch.parallel import mesh
from lpcnet_tpu_torch.training import lpcnet_task, optim
from lpcnet_tpu_torch.utils import weights_io
from lpcnet_tpu_torch.vocoder import Synthesizer

# tests/test_parallel_synthesis.py's small config, GRU-A 96 where it has 64:
# the plain loop sums GRU-B's input product in slices of 48 rows
CFG = dict(gru_a_units=96, gru_b_units=16, cond_size=32, embed_sig_size=16,
           embed_pitch_size=8)
B, T = 16, 2                     # 8 streams per rank; 2 per JAX device

WORKER = '''
import numpy as np
from lpcnet_tpu_torch import convert
from lpcnet_tpu_torch.models import lpcnet
from lpcnet_tpu_torch.parallel import mesh
from lpcnet_tpu_torch.utils import weights_io
from lpcnet_tpu_torch.vocoder import Synthesizer


def synth(rank, world, device, cfg, params_path, feats_path):
    """shard_synthesis gathered onto rank 0, and the error of a batch that
    does not divide over the ranks."""
    voc = Synthesizer(lpcnet.LPCNetConfig(**cfg), device=device,
                      params=convert.params_from_numpy(
                          weights_io.load_params(params_path), device))
    feats = np.load(feats_path)
    try:
        mesh.shard_synthesis(voc, len(feats) + 1)
        error = None
    except ValueError as e:
        error = str(e)
    state, synth_fn = mesh.shard_synthesis(voc, len(feats), gather=True)
    state, pcm = synth_fn(state, feats)
    return {"pcm": pcm, "rows": list(state["rng"].shape), "error": error}
'''


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's full-width step, here and in
    the ranks it spawns (they inherit OMP_NUM_THREADS): with several test
    workers on one host, more threads only contend."""
    n = torch.get_num_threads()
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


def _feats(batch, frames, seed=0):
    """tests/test_parallel_synthesis.py's random features."""
    rs = np.random.RandomState(seed)
    f = np.zeros((batch, frames, 36), np.float32)
    f[..., :18] = rs.randn(batch, frames, 18) * 0.3
    f[..., 18] = rs.uniform(-1, 1, (batch, frames))
    f[..., 19] = rs.uniform(0, 1, (batch, frames))
    return f


@pytest.fixture(scope="module")
def synth_case(tmp_path_factory):
    """The JAX package's parameters at the small config, the features, the
    JAX mesh's pcm and the port's 2-rank gathered pcm."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = j_lm.LPCNetConfig(**CFG)
    jvoc = JSynthesizer(cfg, backend="scan")
    params = jax.tree.map(np.asarray, jvoc.params)
    feats = _feats(B, T, seed=1)
    assert len(jax.devices()) == 8
    state, synth_fn = j_mesh.shard_synthesis(jvoc, B)
    _, pcm_jax = synth_fn(state, feats)
    weights_io.save_params(str(tmp / "p.bin"), params)
    np.save(tmp / "f.npy", feats)
    (tmp / "dp_worker.py").write_text(WORKER)
    out = mesh.spawn("dp_worker:synth", 2, ["cpu", "cpu"],
                     args=[CFG, str(tmp / "p.bin"), str(tmp / "f.npy")],
                     timeout=300, pythonpath=[str(tmp)])
    return params, feats, np.asarray(pcm_jax), out


def test_shard_synthesis_equals_one_process_exactly(synth_case):
    """Two gloo ranks of 8 streams each, gathered onto rank 0: the pcm of
    one Synthesizer on all 16 streams with per-stream seeds, bit for bit.
    Rank 1 gets None."""
    params, feats, _, out = synth_case
    assert out[1]["pcm"] is None
    assert out[0]["rows"] == out[1]["rows"] == [B // 2, 4]
    voc = Synthesizer(t_lm.LPCNetConfig(**CFG), device="cpu",
                      params=convert.params_from_numpy(params, "cpu"))
    _, pcm = voc.synthesize(voc.reset(B, per_stream_rng=True), feats)
    assert out[0]["pcm"].shape == (B, T * 160)
    assert torch.equal(out[0]["pcm"], pcm)


def test_shard_synthesis_matches_jax_mesh(synth_case):
    """The port's 2-rank pcm against JAX's shard_synthesis over 8 CPU
    devices on the same parameters and features: within 1 on <= 1% of the
    samples (ROADMAP.md §3.3)."""
    _, _, pcm_jax, out = synth_case
    d = np.abs(out[0]["pcm"].numpy() - pcm_jax)
    print(f"port 2 ranks vs JAX 8 devices: max |d| {d.max()}, "
          f"differing fraction {(d > 0).mean():.6f}")
    assert d.max() <= 1
    assert (d > 0).mean() <= 0.01


def test_batch_must_divide(synth_case):
    """A batch that does not divide over the ranks raises, in
    shard_synthesis (each rank of the 2-rank world) and shard_batch."""
    for o in synth_case[3]:
        assert o["error"] is not None and "must divide" in o["error"]
    with pytest.raises(ValueError, match="must divide"):
        mesh.shard_batch({"x": np.zeros((5, 3))}, 0, 2)
    rows = mesh.shard_batch({"x": np.arange(8)}, 1, 4)["x"]
    np.testing.assert_array_equal(rows, [2, 3])


def test_dp_training_step_is_the_single_process_step():
    """The flagship LPCNet step (LPCNetConfig(), B=4, T=2) over 2 gloo
    ranks against the single-process step on the whole batch with the same
    noise generator: both ranks' parameters equal exactly (dryrun checks
    it, and so does this test), loss 1e-5 relative, the ranks' averaged
    gradients within 1e-4 of each leaf's largest entry of the whole
    batch's, and the step's parameters exactly Adam and the weight clip on
    those averaged gradients."""
    frames, world = 2, 2
    out = mesh.dryrun_training_step(world, device="cpu", frames=frames,
                                    timeout=300)
    leaves = [optim.tree_leaves(o["params"]) for o in out]
    assert all(torch.equal(a, b) for a, b in zip(*leaves))

    cpu = torch.device("cpu")
    cfg, params, opt, st, noise = mesh.dryrun_setup(cpu)
    batch = {k: torch.as_tensor(v) for k, v in
             mesh.dryrun_batch(world * 2, frames, cfg).items()}
    p1, _, m1 = lpcnet_task.train_step(params, st, batch, cfg, opt, noise)
    rel = abs(out[0]["loss"] / float(m1["loss"]) - 1)
    p_err = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(leaves[0], optim.tree_leaves(p1)))

    nz = mesh.global_noise(torch.Generator().manual_seed(1),
                           batch["sig_in"].shape, cfg, 0, 1)
    (_, _), g = optim.value_and_grad(
        lambda p: lpcnet_task.loss_fn(p, batch, cfg, nz), params)
    halves = []
    for r in range(world):
        lb, ln = (mesh.shard_batch(x, r, world) for x in (batch, nz))
        halves.append(optim.value_and_grad(
            lambda p: lpcnet_task.loss_fn(p, lb, cfg, ln), params)[1])
    avg = optim.tree_map(lambda a, b: (a + b) / world, *halves)
    g_err = max(float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(optim.tree_leaves(avg), optim.tree_leaves(g))
                if float(b.abs().max()) > 0)
    p_avg, _ = opt.apply(params, avg, st)
    p_avg = lpcnet_task.weight_clip(p_avg)
    print(f"DP step: loss relative {rel:.3e}, averaged gradients "
          f"{g_err:.3e} of each leaf's largest entry; updated parameters "
          f"{p_err:.3e} of a leaf's largest entry (Adam's first step, not "
          f"gated)")
    assert rel <= 1e-5
    assert g_err <= 1e-4
    assert all(torch.equal(a, b) for a, b in
               zip(leaves[0], optim.tree_leaves(p_avg)))


def test_global_noise_rows_are_the_single_process_draws():
    """Each rank's rows of the whole batch's noise, drawn from a generator
    seeded alike, are the rows of lpcnet_task's single-process draws."""
    cfg = t_lm.LPCNetConfig(**CFG)
    whole = mesh.global_noise(torch.Generator().manual_seed(5), (4, 40), cfg,
                              0, 1)
    g = torch.Generator().manual_seed(5)
    ref = {"cpcm": torch.randn((4, 40, 3), generator=g),
           "gru_a": torch.randn((4, 40, 96), generator=g)}
    for r in range(2):
        part = mesh.global_noise(torch.Generator().manual_seed(5), (2, 40),
                                 cfg, r, 2)
        for k in ref:
            assert torch.equal(part[k], ref[k][2 * r:2 * r + 2])
            assert torch.equal(whole[k], ref[k])


def test_dryrun_inference_stream_dp_on_cpu():
    """dryrun_inference_stream_dp at LPCNetConfig() with the shipped
    weights over 2 gloo ranks: each rank's 2 rows finite, rank 0 gathers
    (4, 320)."""
    out = mesh.dryrun_inference_stream_dp(2, device="cpu", timeout=300)
    assert [o["shape"] for o in out] == [[2, 320], [2, 320]]
    assert out[0]["gathered"] == [4, 320] and out[1]["gathered"] is None


def test_init_dp_defaults_to_the_card(monkeypatch):
    """init_dp with no device means cuda:LOCAL_RANK, and raises where there
    is no card instead of moving to the CPU; without torchrun's
    environment it says what is missing."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK"):
        mesh.init_dp()
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.init_dp()


def test_spawn_reports_a_failing_rank(tmp_path):
    """A rank that raises ends the whole world at once, and spawn raises
    with that rank's output."""
    (tmp_path / "bad_worker.py").write_text(
        "def boom(rank, world, device):\n"
        "    if rank == 1:\n"
        "        raise ValueError('rank one fails')\n"
        "    import torch.distributed as dist\n"
        "    dist.barrier()\n")
    with pytest.raises(RuntimeError, match="rank one fails"):
        mesh.spawn("bad_worker:boom", 2, ["cpu", "cpu"], timeout=120,
                   pythonpath=[str(tmp_path)])
