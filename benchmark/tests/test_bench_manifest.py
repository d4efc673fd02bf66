"""``BENCHMARK.json`` and the files it names: characters, keys, the files
of every cell, configuration, mix and metric, what each metric moves, the
imports of the benchmark's modules, and that a new configuration, mix,
cell and metric are found by name as new files alone."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT, BENCH = harness.ROOT, harness.BENCH_DIR
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return harness.manifest()


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(bench)) <= 64 * 1024
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["command"]) <= 32 and all(LINE.match(w) for w in bench["command"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_file_a_cell_needs_exists(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"], bench)
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert os.path.exists(os.path.join(BENCH, "drivers", spec["mix"]["driver"] + ".py"))
        assert spec["cell_file"]["why"] == w["why"]
        assert spec["cell_file"]["limits"], f"{w['name']} has no limits"
        assert harness.driver(spec).Cell.kind in ("train", "serve")
    for c in bench["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    files = {os.path.join("benchmark", "configs", f) for f in
             os.listdir(os.path.join(BENCH, "configs"))}
    assert files == {c["file"] for c in bench["configs"]}


def test_every_cell_reports_setup_and_another_end_to_end_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if harness.applies(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(harness.applies(m, w["name"]) for m in bench["per_layer"])


def test_each_metric_moves_what_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert reader.MOVES == m["moves"], m["name"]
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert harness.applies(moved, cell), (m["name"], cell)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _python_files(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _python_files(BENCH):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_port():
    for path in _python_files(os.path.join(BENCH, "reference")):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert "pipnet_tpu_torch" not in tops, path
        assert not tops & set(harness.FORBIDDEN), path


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "pipnet_tpu_torch_lookalike", types.ModuleType("x"))
    assert "pipnet_tpu_torch_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pipnet_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["pipnet_tpu.ops"]


def test_new_files_alone_add_a_configuration_mix_cell_and_metric(bench, tmp_path):
    """A copy of the benchmark's folder gains a configuration, a mix, a
    cell and a metric as new files, and a manifest that lists them: the
    harness finds each by its name."""
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = harness.load_json(os.path.join(BENCH, "configs", "hcompnet_cub190.json"))
    cfg["dataset"] = dict(cfg["dataset"], train_images=4000)
    (copy / "configs" / "new_cfg.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "new_mix.json").write_text(json.dumps(
        {"driver": "train_joint", "epoch": 12, "batch": 32, "warmup_steps": 4,
         "checked_steps": 3, "changes": {}}))
    cell = {"config": "new_cfg", "traffic": "new_mix", "chips": 1, "why": "a new cell",
            "limits": {"loss_rel_gap": 1e-3}}
    (copy / "workloads" / "new_cfg.new_mix.json").write_text(json.dumps(cell))
    (copy / "metrics" / "steps_seen.train.py").write_text(
        'MOVES = "train_images_per_s"\n\n\ndef read(ctx):\n    return ctx.window["steps"]\n')
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "new_cfg", "source": "https://example.org/new",
                           "file": "benchmark/configs/new_cfg.json", "reduced": [],
                           "why": "a new configuration"})
    new["workloads"].append({"name": "new_cfg.new_mix", "config": "new_cfg",
                             "traffic": "new_mix", "chips": 1, "why": "a new cell"})
    for m in new["end_to_end"]:
        if "workloads" in m and "train" in m["name"]:
            m["workloads"].append("new_cfg.new_mix")
    new["per_layer"].append({"name": "steps_seen.train", "unit": "count", "better": "higher",
                             "source": "host_clock", "layer": "step", "moves":
                             "train_images_per_s", "workloads": ["new_cfg.new_mix"]})
    spec = harness.cell_spec("new_cfg.new_mix", new, str(copy))
    assert spec["config_file"]["dataset"]["train_images"] == 4000
    assert spec["mix"]["epoch"] == 12
    assert harness.driver(spec, str(copy)).Cell.kind == "train"
    reader = harness.metric_reader("steps_seen.train", str(copy))
    assert reader.read(type("Ctx", (), {"window": {"steps": 7}})) == 7
