"""The harness finds each configuration, traffic mix, driver, limit file
and metric by name, and a new one is a new file, with no edit."""
import json
import os
import shutil

import pytest

from lpcbench import harness

BENCH = harness.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_has_its_files(cell):
    entry, config, traffic, limits, driver = harness.cell_parts(cell, BENCH)
    assert config["name"] == entry["config"]
    assert hasattr(driver, "setup")
    assert limits and all(isinstance(v, (int, float))
                          for v in limits.values())
    assert harness.cell_metrics(BENCH, cell, False)
    assert harness.cell_metrics(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    mod = harness.load_module(os.path.join(harness.HERE, "metrics",
                                           metric + ".py"), "m_" + metric)
    assert callable(mod.read)
    layer = {m["name"]: m.get("layer") for m in BENCH["per_layer"]}
    if metric in layer:
        assert mod.LAYER == layer[metric]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in moved.get("workloads", cells), (m["name"], cell)


def test_a_new_cell_is_new_files(tmp_path, monkeypatch):
    """A copy of the benchmark with one more cell, mix and metric, added
    as files and entries only: the harness finds all of them."""
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "lpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "synth-b8", "config": "lpcnet-384",
                               "traffic": "closed-b8-4f", "chips": 1,
                               "why": "a new cell"})
    bench["per_layer"].append({"name": "new_metric", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "entry point",
                               "moves": "setup_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((root / "lpcbench/traffic/closed-b1-1f.json")
                     .read_text())
    mix.update(streams=8, frames_per_call=4)
    (root / "lpcbench/traffic/closed-b8-4f.json").write_text(json.dumps(mix))
    shutil.copy(root / "lpcbench/limits/synth-stream-b1.json",
                root / "lpcbench/limits/synth-b8.json")
    (root / "lpcbench/metrics/new_metric.py").write_text(
        'LAYER = "entry point"\n\n\ndef read(run):\n    return 1.0\n')
    monkeypatch.setattr(harness, "HERE", str(root / "lpcbench"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    entry, config, traffic, limits, driver = harness.cell_parts("synth-b8")
    assert traffic["streams"] == 8 and config["name"] == "lpcnet-384"
    names = [m["name"] for m in harness.cell_metrics(harness.benchmark(),
                                                     "synth-b8", True)]
    assert "new_metric" in names
