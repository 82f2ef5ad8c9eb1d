"""The benchmark's files: every name in BENCHMARK.json finds its file, the
contract's limits on names and units hold, and no module of the benchmark
imports JAX or the JAX package (nor a module of the yardstick, reference,
frozen copies or scenes, the port)."""

import ast
import json
import os
import re

import pytest

from rtbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "rtbench")
SPEC = harness.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _modules():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_pieces(cell):
    c = harness.find_cell(ROOT, cell)
    assert harness.driver(c.traffic).run
    assert c.config["name"] == [w for w in SPEC["workloads"] if w["name"] == cell][0]["config"]
    for m in c.per_layer:
        assert callable(harness.load_metric(ROOT, m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer


@pytest.mark.parametrize("kind", ["configs", "scenes", "traffic", "metrics"])
def test_every_file_loads_by_name(kind):
    code = kind in ("metrics", "scenes")
    names = sorted(os.path.splitext(f)[0] for f in os.listdir(os.path.join(BENCH, kind))
                   if f.endswith(".py" if code else ".json"))
    assert names
    for name in names:
        if kind == "metrics":
            assert callable(harness.load_metric(ROOT, name))
        elif kind == "scenes":
            assert callable(harness.load_scene(ROOT, name))
        else:
            assert isinstance(harness._load_json(ROOT, kind, name), dict)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_every_configuration_names_a_scene_that_resolves(config):
    scene = json.load(open(os.path.join(ROOT, config["file"])))["scene"]
    assert callable(harness.load_scene(ROOT, scene))


def test_contract_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for entry in SPEC["configs"] + SPEC["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= {w["name"] for w in SPEC["workloads"]} if "workloads" in m \
            else True
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("rtbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["reduced"] == c["reduced"]
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "tpurt"}, tops
    if any(os.sep + d + os.sep in path for d in ("reference", "frozen", "scenes")):
        assert "tpurt_torch" not in tops


def test_forbidden_modules_compare_whole_names():
    import sys
    sys.modules["tpurt_torch_like"] = sys.modules[__name__]
    try:
        assert "tpurt_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["tpurt_torch_like"]
