"""No process of a run loads JAX or the JAX package, and the reference
imports nothing of the port. Names are compared by their whole top-level
part: lpcnet_tpu_torch is the port, lpcnet_tpu the JAX package."""
import ast
import os
import subprocess
import sys

from lpcbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "lpcnet_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_file_of_the_benchmark_imports_jax():
    for path in _py_files(harness.HERE):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(harness.HERE, "reference")):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & (FORBIDDEN | {"lpcnet_tpu_torch", "lpcbench"}), \
            path


def test_a_run_loads_no_jax():
    """Every module of the benchmark and the port's modules a run uses,
    imported in a fresh process: none of JAX's is loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import lpcbench.harness, lpcbench.control, lpcbench.faults\n"
            "import lpcnet_tpu_torch.vocoder, lpcnet_tpu_torch.plc\n"
            "for d in ('synth', 'plc'):\n"
            "    lpcbench.harness.load_module(\n"
            "        lpcbench.harness.HERE + '/drivers/' + d + '.py', d)\n"
            "print(lpcbench.harness.forbidden_modules())\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ,
                                                          USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lpcnet_tpu_torch_fake", object())
    assert "lpcnet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lpcnet_tpu.fake", object())
    assert harness.forbidden_modules() == ["lpcnet_tpu"]


def test_no_result_is_printed_once_jax_is_loaded(monkeypatch, capsys):
    """The look is the last thing before the result line: a module that
    a reader or the reference loaded is seen too."""
    import pytest
    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit, match="jax"):
        harness.report({"checks": {}, "correct": True})
    assert capsys.readouterr().out == ""
