"""The port's CLI (cli/main.py) and obs/ against what tpurt's offer: the
five verbs and their flags, what each verb writes or prints, the verbs
that raise, and the metric lines, spans and logger."""

import dataclasses
import json
import logging
import os
import re
import sys

import numpy as np
import pytest
import torch

from tpurt.cli.main import build_parser as j_build_parser

from tpurt_torch.api.config import RenderConfig
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.cli.main import build_parser, main
from tpurt_torch.core.scene import get_scene
from tpurt_torch.obs import emit, get_logger, profile_to, trace_span


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the verbs' engines run as lockstep loops of
    small tensor ops, which other test processes' threads slow down many
    times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _verbs(parser):
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return {name: {o for a in sp._actions for o in a.option_strings}
            for name, sp in sub.choices.items()}


def test_parser_has_tpurts_verbs_and_flags():
    """tpurt's verbs and flags, render's --seed (the area-light sampler's)
    among them."""
    got, ref = _verbs(build_parser()), _verbs(j_build_parser())
    assert set(got) == set(ref) == {"render", "build-bvh", "fit", "check-grads", "bench"}
    for verb in ref:
        assert got[verb] == ref[verb], verb
    assert "--seed" in got["render"]
    assert "--config" not in got["render"] and "--set" not in got["render"]


def test_render_writes_the_renderers_image(tmp_path):
    out = tmp_path / "img.npy"
    assert main(["render", "--scene", "cornell", "--width", "20", "--method", "wide8",
                 "-o", str(out)], device="cpu") == 0
    scene, cam = get_scene("cornell", device="cpu")
    cam = dataclasses.replace(cam, width=20, height=20)
    ref = Renderer(scene, RenderConfig(method="wide8")).render(cam)
    assert np.array_equal(np.load(out), ref.numpy())


@pytest.mark.parametrize("method", ["packet", "wave"])
def test_verbs_run_tpurts_own_engines(method, tmp_path):
    """render, fit and check-grads take tpurt's packet and wavefront
    engines: render writes the Renderer's image, fit lowers the loss and
    check-grads passes its gate through the engine."""
    out = tmp_path / "img.npy"
    assert main(["render", "--scene", "cornell", "--width", "16", "--method", method,
                 "-o", str(out)], device="cpu") == 0
    scene, cam = get_scene("cornell", device="cpu")
    cam = dataclasses.replace(cam, width=16, height=16)
    ref = Renderer(scene, RenderConfig(method=method)).render(cam)
    assert np.array_equal(np.load(out), ref.numpy())
    assert main(["fit", "--scene", "cornell", "--width", "8", "--method", method,
                 "--steps", "2"], device="cpu") == 0  # the loss fell
    assert main(["check-grads", "--scene", "cornell", "--width", "8", "--method", method,
                 "--probes", "1"], device="cpu") == 0  # the gate passed


def test_render_png_and_ppm_fallback(tmp_path, monkeypatch):
    args = ["render", "--scene", "cornell", "--width", "8", "--height", "6", "--method", "brute"]
    assert main(args + ["-o", str(tmp_path / "a.png")], device="cpu") == 0
    from PIL import Image

    assert Image.open(tmp_path / "a.png").size == (8, 6)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert main(args + ["-o", str(tmp_path / "b.img")], device="cpu") == 0
    data = (tmp_path / "b.img.ppm").read_bytes()
    assert data.startswith(b"P6\n8 6\n255\n") and len(data) == len(b"P6\n8 6\n255\n") + 8 * 6 * 3


def test_build_bvh_emits_one_metric_line(capsys):
    assert main(["build-bvh", "--scene", "bunny", "--tris", "2000"], device="cpu") == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert row["metric"] == "bvh_build" and row["unit"] == "tris/s"
    assert row["tris"] == get_scene("bunny", num_tris=2000, device="cpu")[0].num_tris
    assert row["value"] == pytest.approx(row["tris"] / row["seconds"])


def test_fit_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    base = ["fit", "--scene", "cornell", "--width", "12", "--method", "wide8",
            "--ckpt", ck, "--ckpt-every", "2"]
    assert main(base + ["--steps", "2"], device="cpu") in (0, 1)
    assert main(base + ["--steps", "4"], device="cpu") in (0, 1)
    assert sorted(os.listdir(ck)) == ["ckpt_00000002.pt", "ckpt_00000004.pt"]


@pytest.mark.parametrize("argv,match", [
    (["bench", "--tris", "2000", "--width", "16", "--height", "16", "--skip-5m"], "wide8"),
    (["render", "--shard", "--width", "4"], "x.npy"),
    (["fit", "--shard", "--width", "8", "--steps", "2", "--ckpt-every", "2"],
     "ckpt_00000002.pt"),
])
def test_unported_verbs_and_flags_raise(argv, match, tmp_path, capsys):
    """The verb and flags that raised until they were ported.  bench runs
    tpurt_torch.bench: on the CPU its headline row, last on stdout, names
    the engine that ran.  --shard (dist/): on the CPU it runs at world 1 on
    a gloo group of its own, writes its image or checkpoint, returns 0 and
    leaves no group of its own behind."""
    import torch.distributed as dist

    if argv[0] == "bench":
        assert main(argv, device="cpu") == 0
        assert json.loads(capsys.readouterr().out.splitlines()[-1])["engine_ran"] == match
        return
    out = ["-o", str(tmp_path / "x.npy")] if argv[0] == "render" else [
        "--ckpt", str(tmp_path)]
    before = dist.is_initialized()
    assert main(argv + out, device="cpu") == 0
    assert match in os.listdir(tmp_path) and dist.is_initialized() == before


def test_render_light_samples_and_seed(tmp_path):
    """render --light-samples (it raised before area lights were ported)
    writes the image; cornell has no emitter, so it is the point-lit one,
    whatever --seed."""
    out = [str(tmp_path / f"{k}.npy") for k in ("a", "b")]
    argv = ["render", "--width", "4", "--method", "brute"]
    assert main(argv + ["--light-samples", "2", "--seed", "5", "-o", out[0]], device="cpu") == 0
    assert main(argv + ["-o", out[1]], device="cpu") == 0
    a, b = (np.load(p) for p in out)
    assert a.shape == (4, 4, 3) and np.array_equal(a, b)


# -- obs -------------------------------------------------------------------
def test_emit_prints_one_json_line(capsys):
    row = emit("x", 1.5, "rays/s", tris=3)
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and json.loads(out) == row
    assert row == {"metric": "x", "value": 1.5, "unit": "rays/s", "tris": 3}


def test_spans_time_and_show_in_the_profiler(tmp_path):
    with torch.profiler.profile() as prof:
        with trace_span("tpurt::build"):
            torch.ones(4) + 1
    assert any(e.name == "tpurt::build" for e in prof.events())
    with profile_to(str(tmp_path / "trace")):
        torch.ones(4) * 2
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_logger_prefix(capsys):
    log = get_logger("tpurt_torch_test")
    log.info("hello %d", 3)
    err = capsys.readouterr().err
    assert re.search(r"\[p0/1\] tpurt_torch_test INFO: hello 3", err)
    assert get_logger("tpurt_torch_test") is log and len(log.handlers) == 1
    log.setLevel(logging.WARNING)

