"""The port's counterpart of jax.jit (lpcnet_tpu_torch/utils/graphs.py) on
the CPU: the signature key, the per-signature cache, disabled(), the copy
in and clone out of a replay (through a stand-in for the CUDA graph), the
entry points' conversion of their arguments before the graphed call, and
that no function of the graphed paths, the training steps' included,
uploads a numpy constant or a Python scalar per call (a CUDA graph cannot
capture the upload). The captures
themselves need the card: tests/test_torch_cuda.py."""
import ast
import importlib
import os
import threading
import weakref

import numpy as np
import pytest
import torch

from lpcnet_tpu_torch.utils import graphs

PKG = os.path.join(os.path.dirname(__file__), os.pardir, "lpcnet_tpu_torch")


def _state(b=2, n=3, dtype=torch.float32):
    return {"a": torch.zeros((b, n), dtype=dtype),
            "b": (torch.ones(b), [torch.zeros(b, dtype=torch.int32)])}


def test_signature_same_shapes_same_key():
    """Values do not enter the key; shapes, dtypes and structure do."""
    k = graphs.signature((_state(), torch.zeros(2, 1, 36)))
    other = {"a": torch.randn(2, 3),
             "b": (torch.full((2,), 7.0), [torch.arange(2).int()])}
    assert graphs.signature((other, torch.randn(2, 1, 36))) == k
    hash(k)


@pytest.mark.parametrize("change", ["shape", "dtype", "dict_key",
                                    "structure", "tuple_vs_list",
                                    "static_value"])
def test_signature_changes_give_a_new_key(change):
    base = (_state(), torch.zeros(2, 1, 36), 160)
    st, f, n = _state(), torch.zeros(2, 1, 36), 160
    if change == "shape":
        f = torch.zeros(2, 2, 36)
    elif change == "dtype":
        st["a"] = st["a"].double()
    elif change == "dict_key":
        st["c"] = st.pop("a")
    elif change == "structure":
        st["b"] = (st["b"][0], st["b"][1][0])
    elif change == "tuple_vs_list":
        st["b"] = list(st["b"])
    else:
        n = 80
    assert graphs.signature((st, f, n)) != graphs.signature(base)


def test_flatten_unflatten_round_trip():
    tree = (_state(), [None, 3], {"x": torch.ones(1)})
    leaves, structure = graphs.flatten(tree)
    assert len(leaves) == 6
    back = graphs.unflatten(structure, leaves)
    assert graphs.signature(back) == graphs.signature(tree)
    assert back[1] == [None, 3] and isinstance(back[0]["b"], tuple)


def test_unhashable_static_leaf_raises():
    with pytest.raises(TypeError, match="hashable"):
        graphs.signature((torch.zeros(1), np.zeros(2)))


def test_disabled_nests_and_restores():
    assert not graphs.is_disabled()
    with graphs.disabled():
        assert graphs.is_disabled()
        with graphs.disabled():
            assert graphs.is_disabled()
        assert graphs.is_disabled()
    assert not graphs.is_disabled()
    with pytest.raises(KeyError):
        with graphs.disabled():
            raise KeyError("x")
    assert not graphs.is_disabled()


def test_disabled_is_per_thread():
    """One thread inside disabled() leaves another thread's entry points
    graphed."""
    seen = {}
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        seen["other"] = graphs.is_disabled()
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with graphs.disabled():
        inside.set()
        done.wait()
        seen["this"] = graphs.is_disabled()
    t.join()
    assert seen == {"this": True, "other": False}


def test_jit_on_cpu_calls_fn_and_caches_nothing():
    calls = []

    def fn(state, x):
        calls.append(x)
        return {"a": state["a"] + 1}, x * 2

    step = graphs.jit(fn, "test.step")
    x = torch.ones(3)
    for _ in range(graphs.CAPTURE_CALL + 1):
        out = step({"a": torch.zeros(3)}, x)
    assert len(calls) == graphs.CAPTURE_CALL + 1 and calls[0] is x
    assert torch.equal(out[1], x * 2) and torch.equal(out[0]["a"], x)
    assert step.steps == {} and step._calls == {}
    assert graphs.captures["test.step"] == graphs.replays["test.step"] == 0
    assert step.pool is None
    # no tensor leaf at all: called as it is
    assert graphs.jit(lambda n: n + 1, "test.int")(2) == 3


def test_jit_holds_a_bound_method_weakly():
    """An engine holds its jit; the jit holds the engine's method weakly,
    so that dropping the engine frees it (and its graphs) at once, with no
    cycle for the garbage collector to find."""

    class Engine:
        def __init__(self):
            self.step = graphs.jit(self._step_impl, "test.Engine.step")

        def _step_impl(self, x):
            return x + 1

    eng = Engine()
    step, ref = eng.step, weakref.ref(eng)
    assert torch.equal(step(torch.zeros(2)), torch.ones(2))
    assert step.fn.__self__ is eng
    del eng
    assert ref() is None
    with pytest.raises(ReferenceError, match="test.Engine.step: its object"):
        step(torch.zeros(2))


def test_jit_raises_on_arguments_spanning_devices():
    step = graphs.jit(lambda a, b: a, "test.mixed")
    with pytest.raises(ValueError, match="test.mixed.*more than one device"):
        step(torch.zeros(2), torch.empty(2, device="meta"))


def test_compile_step_and_jit_capture_raise_on_cpu_tensors():
    """compile_step never calls fn on CPU arguments: there are no CUDA
    graphs there. The error names the entry point."""
    calls = []
    with pytest.raises(RuntimeError, match="Engine.step captures a CUDA "
                                           "graph; the arguments are on cpu"):
        graphs.compile_step(lambda *a: calls.append(a),
                            (_state(), torch.zeros(1)), "Engine.step")
    with pytest.raises(RuntimeError, match="CUDA graph"):
        graphs.compile_step(lambda *a: calls.append(a), (3,))
    assert calls == []


class _StandInGraph:
    """A graph that, when replayed, runs fn on the static inputs and writes
    the results into the static outputs, as a captured graph would."""

    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        new = self.fn(*self.args)
        for o, n in zip(graphs.flatten(self.out)[0], graphs.flatten(new)[0]):
            o.copy_(n)


def _stand_in_step(fn, args, name="stand_in"):
    static = graphs.unflatten(graphs.flatten(args)[1],
                              [graphs._static(x)
                               for x in graphs.flatten(args)[0]])
    out = fn(*static)
    return graphs.CompiledStep(_StandInGraph(fn, static, out), static, out,
                               name)


def _pass_through_fn(state, x):
    # "keep" passes an input leaf through, as {**state, ...} does
    return {**state, "a": state["a"] + x.sum()}, x[:, ::2] * 3


def test_compiled_step_copies_in_and_returns_clones():
    """A replay reads the arguments it is given (copied into the graph's
    contiguous static inputs), and every output it returns, inputs passed
    through included, is a clone that the next replay does not touch."""
    st = {"a": torch.zeros(2), "keep": torch.tensor([1.0, 2.0])}
    x = torch.arange(8.0).reshape(2, 4)
    step = _stand_in_step(_pass_through_fn, (st, x))
    assert all(t.is_contiguous() for t in graphs.flatten(step.args)[0])
    st1, y1 = step(st, x)
    st2 = {"a": torch.ones(2), "keep": torch.tensor([5.0, 6.0])}
    x2 = torch.arange(16.0).reshape(4, 4)[::2]          # not contiguous
    out2 = step(st2, x2)
    assert step.replays == 2
    ref1, ref2 = _pass_through_fn(st, x), _pass_through_fn(st2, x2)
    for got, ref in ((st1, ref1[0]), (out2[0], ref2[0])):
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert torch.equal(y1, ref1[1]) and torch.equal(out2[1], ref2[1])
    static_keep = step.args[0]["keep"]
    assert st1["keep"] is not static_keep and out2[0]["keep"] is not \
        static_keep
    with pytest.raises(ValueError, match="stand_in: a compiled step takes"):
        step(st, torch.zeros(3, 4))


def test_jit_captures_once_per_signature(monkeypatch):
    """The cache as it runs on the card, with the capture stood in: the
    first call of a signature runs eagerly (the capture's warm-up), the
    second captures it with no further warm-up, that call and every later
    one replay; one pool for all the graphs; eager calls inside
    disabled()."""
    made, pools, eager = [], [], []
    name = "test.cache.step"

    def stand_in_compile(fn, args, name, pool, warmup, capture_error_mode):
        assert capture_error_mode == "global"
        made.append((name, warmup))
        pools.append(pool)
        return _stand_in_step(fn, args, name)

    def fn(state, x):
        eager.append(tuple(x.shape))
        return _pass_through_fn(state, x)

    monkeypatch.setattr(graphs, "_device", lambda args, name: torch.device(
        "cuda", 0))
    monkeypatch.setattr(graphs, "compile_step", stand_in_compile)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    step = graphs.jit(fn, name)
    st = {"a": torch.zeros(2), "keep": torch.ones(2)}
    for x in (torch.ones(2, 4), torch.zeros(2, 4), torch.ones(2, 6),
              torch.ones(2, 4), torch.ones(2, 6)):
        out = step(st, x)
        assert torch.equal(out[1], _pass_through_fn(st, x)[1])
    assert graphs.CAPTURE_CALL == 2
    assert made == [(name, 0)] * 2 and len(step.steps) == 2
    # the eager calls, the captures (the stand-in calls fn once) and the
    # replays of the stand-in graph (it calls fn again)
    assert eager[:3] == [(2, 4), (2, 4), (2, 4)]
    assert graphs.replays[name] == 3 and step._calls == {}
    assert pools == [("pool",)] * 2
    with graphs.disabled():
        step(st, torch.ones(3, 4))
    assert len(made) == 2 and graphs.replays[name] == 3
    assert step._calls == {}


def test_jit_takes_a_fresh_pool_until_a_capture_holds_one(monkeypatch):
    """A capture that fails leaves the jit without a graph, and its graph
    releases the pool whenever it is freed: the next capture takes a new
    pool; once a graph holds one, later captures share it."""
    handles, pools = iter(range(1, 10)), []

    def stand_in_compile(fn, args, name, pool, warmup, capture_error_mode):
        pools.append(pool)
        if len(pools) == 1:
            raise RuntimeError(f"{name}: the call could not be captured")
        return _stand_in_step(fn, args, name)

    monkeypatch.setattr(graphs, "_device", lambda args, name: torch.device(
        "cuda", 0))
    monkeypatch.setattr(graphs, "compile_step", stand_in_compile)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle",
                        lambda: next(handles))
    step = graphs.jit(_pass_through_fn, "test.pool.step")
    st = {"a": torch.zeros(2), "keep": torch.ones(2)}
    x = torch.ones(2, 4)
    step(st, x)
    with pytest.raises(RuntimeError, match="could not be captured"):
        step(st, x)
    assert step.steps == {}
    for y in (x, x, torch.ones(2, 6), torch.ones(2, 6)):
        step(st, y)
    assert pools == [1, 2, 2] and len(step.steps) == 2


def _tiny_entry_points():
    """(name, the jit, a call of the public method with numpy arguments)
    for every graphed entry point, on the CPU with the fn of each jit
    replaced by a recorder."""
    from lpcnet_tpu_torch import convert
    from lpcnet_tpu_torch.dred import DREDCodec
    from lpcnet_tpu_torch.models import plc as plc_model
    from lpcnet_tpu_torch.models import rdovae
    from lpcnet_tpu_torch.plc import (NonCausalPLCEngine, PLCEngine,
                                      StrictCausalPLCEngine)
    from lpcnet_tpu_torch.models import lpcnet
    from lpcnet_tpu_torch.vocoder import Synthesizer
    cfg = lpcnet.LPCNetConfig(gru_a_units=16, gru_b_units=8, cond_size=16)
    gen = torch.Generator().manual_seed(0)
    params = lpcnet.init_params(gen, cfg)
    pp = plc_model.init_params(gen)
    voc = Synthesizer(cfg, params=params, device="cpu")
    f = np.zeros((1, 2, 36), np.float32)
    pcm, lost = np.zeros((1, 160), np.float32), np.zeros(1, bool)
    cfg0 = lpcnet.LPCNetConfig(gru_a_units=16, gru_b_units=8, cond_size=16,
                               lookahead=0)
    engines = [PLCEngine(params, pp, cfg, device="cpu"),
               StrictCausalPLCEngine(params, pp, cfg, device="cpu"),
               NonCausalPLCEngine(lpcnet.init_params(gen, cfg0), pp, cfg0,
                                  device="cpu")]
    rcfg = rdovae.RDOVAEConfig(cond_size=32, cond_size2=32)
    dc = DREDCodec(convert.to_device(rdovae.init_params(gen, rcfg), "cpu"),
                   rcfg, device="cpu")
    cases = [
        ("Synthesizer.synthesize", voc._synth,
         lambda: voc.synthesize(voc.reset(1), f)),
        ("Synthesizer.synthesize_teacher", voc._synth_teacher,
         lambda: voc.synthesize_teacher(voc.reset(1), f,
                                        np.zeros((1, 320), np.float32),
                                        np.zeros((1, 2), np.int64))),
        ("Synthesizer.synthesize_streaming", voc._synth_streaming,
         lambda: voc.synthesize_streaming(voc.reset_streaming(1), f)),
        ("DREDCodec.encode", dc._encode,
         lambda: dc.encode(np.zeros((1, 4, 20), np.float32))),
        ("DREDCodec.decode", dc._decode,
         lambda: dc.decode(np.zeros((1, 16, rcfg.nb_latents), np.int32),
                           np.arange(16), np.zeros((1, rcfg.state_dim),
                                                   np.float32))),
    ]
    for eng in engines:
        name = type(eng).__name__ + ".step"
        cases.append((name, eng._step,
                      lambda eng=eng: eng.step(eng.init_state(1), pcm, lost)))
    return cases


def test_entry_points_convert_arguments_before_the_graphed_call():
    """Every entry point of the slice goes through its jit, named after
    it, and hands it tensors on the entry point's device: numpy arguments
    are converted before the graphed call, never inside it."""
    cases = _tiny_entry_points()
    assert len(cases) == 8
    # synthesize_temperature (jitted at lpcnet_tpu/vocoder.py:123) has a jit
    # of its conditioning; its sample step is a graphs.loop_step per batch
    # size (tests/test_torch_jit_sites.py)
    voc = cases[0][1].fn.__self__
    assert sorted(k for k, v in vars(voc).items()
                  if isinstance(v, graphs.jit)) == [
        "_synth", "_synth_streaming", "_synth_teacher", "_temp_conds"]
    for name, step, call in cases:
        assert isinstance(step, graphs.jit) and step.name == name
        got = []
        step.fn = lambda *a, got=got: got.append(a) or "out"
        assert call() == "out", name
        leaves = graphs.flatten(got[0])[0]
        assert leaves and all(isinstance(x, torch.Tensor)
                              and x.device.type == "cpu" for x in leaves), \
            name
        assert graphs.captures[name] == 0 and step.steps == {}


def test_teacher_shapes_are_checked_before_the_graphed_call():
    cases = dict((n, (s, c)) for n, s, c in _tiny_entry_points())
    step, _ = cases["Synthesizer.synthesize_teacher"]
    voc = step.fn.__self__
    step.fn = lambda *a: pytest.fail("called with bad shapes")
    with pytest.raises(ValueError, match="target must be"):
        voc.synthesize_teacher(voc.reset(1), np.zeros((1, 2, 36)),
                               np.zeros((1, 300)), np.zeros((1, 2)))


# the modules whose functions run inside the entry points', the training
# steps' and the other jit sites' graphs (the feature, codec and Burg
# steps, the k-means updates, the data-parallel step, the tools' steps)
GRAPHED_MODULES = (
    ["features", "plc", "dred", "vocoder", "data", "kernels.sample_scan",
     "kernels.sample_cuda", "kernels.burg_cuda", "parallel.mesh",
     "tools.eval_plc", "tools.fit_pade", "tools.train_codebooks"]
    + [d + "." + f[:-3] for d in ("ops", "models", "training", "codec")
       for f in sorted(os.listdir(os.path.join(PKG, d)))
       if f.endswith(".py") and f != "__init__.py"])
_UPLOADS = ("as_tensor", "tensor", "from_numpy")
# the functions of those modules that run before a step, never inside one:
# they make parameters, a KISS99 seed, a corpus batch or a fit's grid, load
# a checkpoint, or build training pairs on the host
OUTSIDE_STEPS = {"ops.kiss99": {"to_tensor"},
                 "models.rdovae": {"rate_aware_quant_init"},
                 "training.optim": {"state_from_leaves"},
                 "data": {"build_pairs"},
                 "tools.fit_pade": {"grid"},
                 "tools.train_codebooks": {"build_corpus"}}


def constant_uploads(source: str, module) -> list:
    """(function, line, text) of every per-call upload inside a function
    or method of `source` (nested functions count as their outermost
    one's): a call of torch.as_tensor / torch.tensor /
    torch.from_numpy whose data argument holds a module-level numpy
    constant of `module` (a name bound to an ndarray there, or an ndarray
    attribute of a module bound there) or a numpy expression (a call of
    np.* or numpy.*), and every call of Tensor.new_tensor."""
    consts = {n for n, v in vars(module).items() if isinstance(v, np.ndarray)}

    def is_const(node) -> bool:
        if isinstance(node, ast.Name):
            return node.id in consts
        if isinstance(node, ast.Attribute) and isinstance(node.value,
                                                          ast.Name):
            owner = vars(module).get(node.value.id)
            return isinstance(getattr(owner, node.attr, None), np.ndarray)
        return False

    def is_numpy_call(node) -> bool:
        f = node.func if isinstance(node, ast.Call) else None
        while isinstance(f, ast.Attribute):
            f = f.value
        return isinstance(f, ast.Name) and f.id in ("np", "numpy")

    def top_functions(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node
            elif isinstance(node, ast.ClassDef):
                yield from top_functions(node.body)

    found = []
    for fn in top_functions(ast.parse(source).body):
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)):
                continue
            if call.func.attr == "new_tensor":
                found.append((fn.name, call.lineno, ast.unparse(call)))
                continue
            if not (call.func.attr in _UPLOADS
                    and isinstance(call.func.value, ast.Name)
                    and call.func.value.id == "torch"):
                continue
            data = call.args[:1] + [k.value for k in call.keywords
                                    if k.arg == "data"]
            for arg in data:
                found += [(fn.name, call.lineno, ast.unparse(n))
                          for n in ast.walk(arg)
                          if is_const(n) or is_numpy_call(n)]
    return sorted(set(found), key=lambda f: f[1])


@pytest.mark.parametrize("name", GRAPHED_MODULES)
def test_no_function_uploads_a_numpy_constant_per_call(name):
    """Each such upload is a pageable host copy in every call, which a
    CUDA graph cannot capture: ops/tables.device_constant keeps the tensor
    on the device instead, and a scalar bound is filled on the device
    (new_full)."""
    module = importlib.import_module("lpcnet_tpu_torch." + name)
    with open(module.__file__) as fh:
        found = constant_uploads(fh.read(), module)
    assert [f for f in found
            if f[0] not in OUTSIDE_STEPS.get(name, ())] == []


def test_the_upload_check_finds_an_upload():
    """The check above on the forms it must catch: a constant of the
    module, a constant of an imported module, inside an expression, a
    numpy expression, a new_tensor."""
    from lpcnet_tpu_torch.kernels import sample_scan
    src = ("import torch\n"
           "def f(x):\n"
           "    a = torch.as_tensor(NODE_LEVEL, device=x.device)\n"
           "    b = torch.tensor(tables.DCT_TABLE * 2)\n"
           "    c = torch.from_numpy(np.asarray(FLAT_SCORE_W))\n"
           "    d = torch.as_tensor(0.9 ** np.arange(1, 17), device=x.device)\n"
           "    e = x.new_tensor(0.5)\n"
           "    return torch.as_tensor(x)\n")
    module = type(sample_scan)("m")
    module.NODE_LEVEL = sample_scan.NODE_LEVEL
    module.FLAT_SCORE_W = sample_scan.FLAT_SCORE_W
    module.tables = importlib.import_module("lpcnet_tpu_torch.ops.tables")
    got = constant_uploads(src, module)
    assert sorted({(f, line) for f, line, _ in got}) == [
        ("f", 3), ("f", 4), ("f", 5), ("f", 6), ("f", 7)]


# the training steps' per-call uploads as the port had them before its
# steps were captured, function by function and verbatim: the widened
# check must find each (the module, the function, its source, the lines
# of the uploads in it)
BEFORE_CAPTURE = [
    ("training.optim", "update", """\
def update(self, grads, state):
    b1, b2 = self.b1, self.b2
    n = state["count"] + 1
    bc1 = _f32(1) - _f32(b1) ** _f32(n)
    bc2 = _f32(1) - _f32(b2) ** _f32(n)
    step = self.step_size(state["sched_count"])

    def moments(g, m, v):
        m = (1 - b1) * g + b1 * m
        v = (1 - b2) * (g * g) + b2 * v
        upd = (m / g.new_tensor(bc1)) / (
            torch.sqrt(v / g.new_tensor(bc2)) + self.eps)
        return m, v, g.new_tensor(step) * upd
""", [11, 12, 13]),
    ("training.lpcnet_task", "forward", """\
def forward(params, batch, cfg, noise=None, train=True):
    sig_in = batch["sig_in"].to(torch.float32)
    gamma_w = torch.as_tensor(
        cfg.lpc_gamma ** np.arange(1, cfg.lpc_order + 1, dtype=np.float32),
        device=sig_in.device)
""", [3]),
    ("training.lpcnet_task", "clip_kernel", """\
def clip_kernel(p, c):
    a = torch.abs(p)
    pair = a[0::2] + a[1::2]
    return c * p / torch.maximum(p.new_tensor(c),
                                 pair.repeat_interleave(2, dim=0))
""", [4]),
    ("training.losses", "l2u", """\
def l2u(x):
    u = torch.sign(x) * (128.0 * torch.log1p(_SCALE * ties.abs(x))
                         / x.new_tensor(_LOG256))
    return ties.clip(128.0 + u, 0.0, 255.0)
""", [3]),
    ("ops.ties", "maximum", """\
def maximum(x, c):
    return torch.maximum(x, x.new_tensor(c))
""", [2]),
    ("ops.ties", "minimum", """\
def minimum(x, c):
    return torch.minimum(x, x.new_tensor(c))
""", [2]),
]


@pytest.mark.parametrize("case", BEFORE_CAPTURE,
                         ids=[f"{m}.{f}" for m, f, _, _ in BEFORE_CAPTURE])
def test_the_widened_check_finds_the_training_steps_uploads(case):
    """On the source the port had before its training steps were
    captured, the check finds every per-call upload of the steps: the
    optimizer's bias corrections and step size, LPCNet's gamma weights,
    the weight clip's bound, the mu-law's log 256 and the ties' bounds."""
    name, fn, src, lines = case
    module = importlib.import_module("lpcnet_tpu_torch." + name)
    got = constant_uploads(src, module)
    assert sorted({line for f, line, _ in got if f == fn}) == lines


def test_reset_like_is_a_fresh_state_with_the_rng_kept():
    """The non-causal step's cleared sample state, made on the device with
    no host seed: init_state's values, the given state's RNG."""
    from lpcnet_tpu_torch.kernels import sample_scan
    from lpcnet_tpu_torch.models import lpcnet
    cfg = lpcnet.LPCNetConfig()
    fresh = sample_scan.init_state(3, cfg, device="cpu")
    used = {k: v + 1 for k, v in fresh.items()}
    got = sample_scan.reset_like(used)
    assert list(got) == list(fresh) and got["rng"] is used["rng"]
    for k, v in fresh.items():
        if k != "rng":
            assert torch.equal(got[k], v) and got[k].dtype == v.dtype, k
