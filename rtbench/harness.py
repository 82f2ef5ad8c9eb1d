"""The benchmark's core: find a cell's pieces by name, run its driver, read
its metrics, and make the result line.

Everything a cell is made of is found by name under the benchmark's root
(``BENCHMARK.json`` beside the ``rtbench`` folder):

- ``rtbench/configs/<config>.json``: the deployment (scene, frame, engine);
- ``rtbench/scenes/<scene>.py``: the scene that a configuration's ``scene``
  key names, a function ``arrays(num_tris, seed)`` that returns the
  scene's ``frozen.scene.SceneArrays``;
- ``rtbench/traffic/<traffic>.json``: the traffic mix; its ``driver`` key
  names the general generator in ``rtbench/drivers/`` that reads it;
- ``rtbench/metrics/<metric>.py``: one per-layer metric's reader, a
  function ``read(ctx)`` that returns a number or None (nothing to read).

So a later change adds a cell, a scene, a mix or a metric by adding files
and entries; no file here needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Callable

FORBIDDEN = ("jax", "jaxlib", "flax", "tpurt")


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its configuration and traffic."""

    name: str
    root: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclass
class Measured:
    """What a driver hands back: its end-to-end values by metric name,
    the numbers compared by the check with their limits, the requests
    attempted and failed, and the context the per-layer readers read."""

    end_to_end: dict[str, float]
    checks: dict[str, dict]
    attempted: int
    failed: int
    ctx: Any = None
    notes: dict = field(default_factory=dict)


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(root: str, kind: str, name: str) -> dict:
    path = os.path.join(root, "rtbench", kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: str, name: str) -> Cell:
    spec = load_spec(root)
    match = [w for w in spec["workloads"] if w["name"] == name]
    if not match:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = match[0]
    config = _load_json(root, "configs", w["config"])
    traffic = _load_json(root, "traffic", w["traffic"])
    return Cell(name=name, root=root, config=config, traffic=traffic, chips=int(w["chips"]),
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def _load_module(root: str, kind: str, name: str):
    path = os.path.join(root, "rtbench", kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"rtbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(root: str, name: str) -> Callable:
    """The read(ctx) function of rtbench/metrics/<name>.py."""
    return _load_module(root, "metrics", name).read


def load_scene(root: str, name: str | None) -> Callable:
    """The arrays(num_tris, seed) function of rtbench/scenes/<name>.py, the
    scene a configuration's ``scene`` key names.  A configuration without
    the key, or naming no file, is an error that names the file looked for:
    nothing falls back to another scene."""
    where = os.path.join(root, "rtbench", "scenes")
    if not name:
        raise ValueError("the configuration names no scene: its \"scene\" key names a file "
                         + os.path.join(where, "<scene>.py"))
    path = os.path.join(where, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"the configuration names the scene {name!r}, and {path} "
                                "does not exist")
    return _load_module(root, "scenes", name).arrays


def driver(traffic: dict):
    return importlib.import_module(f"rtbench.drivers.{traffic['driver']}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def metrics_line(cell: Cell, measured: Measured, trace: bool) -> dict:
    """The cell's metrics: its end-to-end ones (trace off), or its
    per-layer ones read from the traced run (trace on); a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    if not trace:
        for m in cell.end_to_end:
            if m["name"] in measured.end_to_end:
                out[m["name"]] = {"value": measured.end_to_end[m["name"]], "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        value = load_metric(cell.root, m["name"])(measured.ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        device: str, t_start: float) -> tuple[dict, Measured]:
    """Run one cell on `device` ("cuda", or "cpu" in the tests) and return
    (the result line's object, what the driver measured)."""
    cell = find_cell(root, workload)
    measured = driver(cell.traffic).run(cell, seed=seed, seconds=seconds, trace=trace,
                                        device=device, t_start=t_start)
    correct = all(c["value"] <= c["limit"] for c in measured.checks.values())
    result = {"correct": correct, "attempted": measured.attempted, "failed": measured.failed,
              "metrics": metrics_line(cell, measured, trace),
              "device": measured.notes.get("device", {})}
    if trace and measured.notes.get("breakdown"):
        result["breakdown"] = measured.notes["breakdown"]
    result["checks"] = measured.checks
    return result, measured
