"""Tiny cells run end to end on the CPU (the harness's look for a card
skipped, the port's plain-torch twins in place of its kernels): the result
line is the contract's, on the courtyard and on the bunny; a config, a
scene, a traffic mix and a metric added as new files are found by name; a
configuration that names no scene file stops the run; the check says not
correct with the timed path broken underneath, and for the bfloat16
control."""

import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rtbench import control, faults, harness
from rtbench.drivers import common
from rtbench.frozen import scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {"num_tris": 2000, "width": 24, "height": 16}
TINY_BUNNY = {"name": "tinybunny", "scene": "bunny", "num_tris": 1500, "scene_seed": 0,
              "width": 24, "height": 16, "engine": "wide8", "reduced": []}
# Views and a fit camera around the knot, which sits at the origin.
KNOT_VIEWS = [{"kind": "orbit", "count": 4, "radius": 5.2, "height": 1.8, "target": [0, 0, 0]},
              {"kind": "orbit", "count": 4, "radius": 4.0, "height": 3.5, "target": [0, 0, 0]}]
KNOT_MIXES = {"knot8": ("path32", {"views": KNOT_VIEWS, "fov_deg": 40.0}),
              "knot8_area": ("path32_area", {"views": KNOT_VIEWS, "fov_deg": 40.0}),
              "fit_knot": ("fit_overview", {"eye": [0.0, 1.8, 5.2], "target": [0.0, 0.0, 0.0],
                                            "fov_deg": 40.0})}
CELLS = {"tiny.frames": ("tiny", "path32"), "tiny.area": ("tiny", "path32_area"),
         "tiny.fit": ("tiny", "fit_overview"), "tinybunny.frames": ("tinybunny", "knot8"),
         "tinybunny.area": ("tinybunny", "knot8_area"), "tinybunny.fit": ("tinybunny", "fit_knot")}


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark root of its own: the data files and scenes, a tiny
    courtyard and a tiny bunny configuration and the knot's mixes added as
    new files, and BENCHMARK.json naming their cells."""
    for kind in ("configs", "scenes", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "rtbench", kind), tmp_path / "rtbench" / kind,
                        ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec(ROOT)
    cfg = json.load(open(os.path.join(ROOT, "rtbench", "configs", "sponza1m.json")))
    cfg.update(TINY, name="tiny")
    for c in (cfg, TINY_BUNNY):
        (tmp_path / "rtbench" / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": c["name"], "source": "a test",
                                "file": f"rtbench/configs/{c['name']}.json", "reduced": [],
                                "why": "a test"})
    for name, (base, changes) in KNOT_MIXES.items():
        mix = json.load(open(os.path.join(ROOT, "rtbench", "traffic", f"{base}.json")))
        (tmp_path / "rtbench" / "traffic" / f"{name}.json").write_text(
            json.dumps({**mix, **changes}))
    spec["workloads"] += [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "a test"}
                          for n, (c, t) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            frames = any(w.endswith((".frames", ".area")) for w in m["workloads"])
            m["workloads"] += [n for n in CELLS if n.endswith(".fit") != frames]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return str(tmp_path)


def _run(root, cell, seed=2 ** 31 + 11, seconds=0.5):
    return harness.run(root, cell, seed, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_prints_the_contracts_line(tiny_root, cell):
    result, _ = _run(tiny_root, cell)
    line = json.loads(json.dumps(result))
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    spec = harness.find_cell(tiny_root, cell)
    assert set(line["metrics"]) == {m["name"] for m in spec.end_to_end}
    assert all(m["value"] > 0 for k, m in line["metrics"].items() if k != "peak_mem_gib")
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_same_seed_same_inputs(tiny_root):
    a = _run(tiny_root, "tiny.area", seed=5)[1]
    b = _run(tiny_root, "tiny.area", seed=5)[1]
    assert a.checks == b.checks


def test_new_files_are_found_by_name(tiny_root):
    base = os.path.join(tiny_root, "rtbench")
    cfg = json.load(open(os.path.join(base, "configs", "tiny.json")))
    cfg.update(name="tiny2", num_tris=1500, scene="half_courtyard")
    json.dump(cfg, open(os.path.join(base, "configs", "tiny2.json"), "w"))
    with open(os.path.join(base, "scenes", "half_courtyard.py"), "w") as f:
        f.write("import numpy as np\n"
                "from rtbench.frozen import scene\n"
                "def arrays(num_tris, seed):\n"
                "    a = scene.sponza_arrays(num_tris, seed)\n"
                "    return scene.SceneArrays(**{**a.__dict__, 'verts': a.verts * np.float32(0.5)})\n")
    mix = json.load(open(os.path.join(base, "traffic", "path32.json")))
    mix["views"][0]["count"] = 2
    json.dump(mix, open(os.path.join(base, "traffic", "path4.json"), "w"))
    with open(os.path.join(base, "metrics", "frames_window_s.py"), "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx.dispatch_ms))\n")
    spec = json.load(open(os.path.join(tiny_root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "tiny2.path4", "config": "tiny2", "traffic": "path4",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "frames_window_s", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "api",
                              "moves": "frame_rays_per_s", "workloads": ["tiny2.path4"]})
    for m in spec["end_to_end"]:
        if "frame_rays_per_s" == m["name"] or "frame_ms.p95" == m["name"]:
            m["workloads"].append("tiny2.path4")
    json.dump(spec, open(os.path.join(tiny_root, "BENCHMARK.json"), "w"))
    cell = harness.find_cell(tiny_root, "tiny2.path4")
    assert cell.config["num_tris"] == 1500 and cell.traffic["views"][0]["count"] == 2
    assert np.array_equal(common.scene_arrays(cell).verts,
                          scene.sponza_arrays(1500, 7).verts * np.float32(0.5))
    result, measured = _run(tiny_root, "tiny2.path4")
    assert result["correct"] and "frame_rays_per_s" in result["metrics"]
    assert harness.load_metric(tiny_root, "frames_window_s")(measured.ctx) == \
        measured.attempted


@pytest.mark.parametrize("named", [None, "no_such_scene"])
def test_a_configuration_must_name_a_scene_file(tiny_root, named):
    """Without a scene, or naming no file under scenes/, the run stops with
    the file it looked for in its message: nothing falls back to the
    courtyard."""
    path = os.path.join(tiny_root, "rtbench", "configs", "tiny.json")
    cfg = json.load(open(path))
    cfg.pop("scene")
    if named:
        cfg["scene"] = named
    json.dump(cfg, open(path, "w"))
    looked = os.path.join(tiny_root, "rtbench", "scenes", f"{named or '<scene>'}.py")
    with pytest.raises((ValueError, FileNotFoundError), match=re.escape(looked)):
        _run(tiny_root, "tiny.frames")


# -- faults planted in the timed path: the check has to say not correct ----
FRAMES_CELLS = ["tiny.frames", "tiny.area", "tinybunny.frames", "tinybunny.area"]


@pytest.mark.parametrize("fault", faults.NAMES["frames"])
@pytest.mark.parametrize("cell", FRAMES_CELLS)
def test_frames_check_fails_on_a_broken_path(tiny_root, cell, fault):
    with faults.planted("frames", fault):
        result, _ = _run(tiny_root, cell)
    assert result["correct"] is False


@pytest.mark.parametrize("fault", faults.NAMES["fit"])
@pytest.mark.parametrize("cell", ["tiny.fit", "tinybunny.fit"])
def test_fit_check_fails_on_a_broken_step(tiny_root, cell, fault):
    with faults.planted("fit", fault):
        result, _ = _run(tiny_root, cell)
    assert result["correct"] is False


# -- the control: the reference in bfloat16 in the port's place -------------
@pytest.mark.parametrize("cell", FRAMES_CELLS)
def test_frames_control_is_not_correct(tiny_root, cell):
    r = control.reading(tiny_root, cell, 3, "cpu", frames=64)
    assert r["px_off_frac"] > r["limit"]


@pytest.mark.parametrize("name", ["tiny.fit", "tinybunny.fit"])
def test_fit_control_is_not_correct(tiny_root, name):
    cell = harness.find_cell(tiny_root, name)
    r = control.fit_reading(cell, 3, "cpu")
    assert any(r[k] > cell.traffic["check"][k] for k in ("loss_gap", "grad1_gap", "change_gap"))


def test_run_refuses_without_a_card_or_the_ports_sources(tmp_path):
    shutil.copytree(os.path.join(ROOT, "rtbench"), tmp_path / "rtbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    cmd = [sys.executable, "rtbench/run.py", "--workload", "sponza1m.frames", "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert alone.returncode != 0 and alone.stdout.strip() == ""
    if not torch.cuda.is_available():
        here = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert here.returncode != 0 and here.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card(card):
    cmd = [sys.executable, "rtbench/run.py", "--workload", "sponza1m.frames", "--seed",
           str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_fit_reference_follows_the_ports_first_step(tiny_root):
    """The reference's first step against the port's on the CPU twins: the
    loss and the first gradient's norms agree to rounding."""
    _, m = _run(tiny_root, "tiny.fit")
    assert abs(m.notes["losses"][0] / m.notes["reference_losses"][0] - 1) < 1e-5
    assert all(abs(m.notes["grad1"][k] / v - 1) < 1e-4
               for k, v in m.notes["reference_grad1"].items())
