"""The port's spans (obs/trace.py trace_span) at its stage boundaries: a
hard frame, an area frame, a soft render and a 2-chunk fit step under
torch.profiler show the tpurt:: ranges under their names, nested by time
as the benchmark's readers expect; with no profiler running, no span
enters record_function."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.core.geometry import Rays
from tpurt_torch.core.scene import make_cornell_box
from tpurt_torch.obs import trace as trace_mod
from tpurt_torch.obs.trace import trace_span
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render_rays

SOFT = dict(soft=True, k_layers=2, sharpness=40.0, band=0.08, k_occ=4)
HARD_ENGINES = ("brute", "bvh", "binary", "wide8", "packet", "wave")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(width=8):
    """Cornell at width x width with its ceiling's two triangles emissive."""
    scene, cam = make_cornell_box(device="cpu")
    emission = torch.zeros_like(scene.tris.albedo)
    emission[2:4] = 4.0
    tris = dataclasses.replace(scene.tris, emission=emission)
    return (dataclasses.replace(scene, tris=tris),
            dataclasses.replace(cam, width=width, height=width))


def _rays(cam):
    r = gen_primary_rays(cam)
    return Rays(o=r.o, d=r.d)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _spans(fn):
    """fn() under a CPU profile -> [(name, start, end)] of its tpurt:: ranges,
    in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("tpurt::")), key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


@pytest.mark.parametrize("method", HARD_ENGINES)
def test_hard_frame_nests_its_walks_in_render_rays(method):
    scene, cam = _scene()
    tracer = make_tracer(scene, method)
    spans = _spans(lambda: render_rays(tracer, _rays(cam)))
    (frame,) = _named(spans, "tpurt::render_rays")
    (closest,) = _named(spans, "tpurt::walk.closest")
    (occluded,) = _named(spans, "tpurt::walk.occluded")   # cornell's one light
    assert _inside(closest, frame) and _inside(occluded, frame)
    assert closest[2] <= occluded[1]
    assert {s[0] for s in spans} == {"tpurt::render_rays", "tpurt::walk.closest",
                                     "tpurt::walk.occluded"}


def test_area_frame_adds_the_area_span_with_its_sampling_and_walk():
    scene, cam = _scene()
    tracer = make_tracer(scene, "wide8")
    spans = _spans(lambda: render_rays(tracer, _rays(cam), light_samples=2,
                                       generator=_gen()))
    (frame,) = _named(spans, "tpurt::render_rays")
    (area,) = _named(spans, "tpurt::area")
    (sample,) = _named(spans, "tpurt::area.sample")
    occluded = _named(spans, "tpurt::walk.occluded")
    assert _inside(area, frame) and _inside(sample, area)
    assert len(occluded) == 2
    point, area_walk = occluded
    assert not _inside(point, area) and _inside(area_walk, area)
    assert sample[2] <= area_walk[1]


def test_soft_render_shows_two_knear_walks():
    scene, cam = _scene()
    tracer = make_tracer(scene, "wide8", band=SOFT["band"])
    spans = _spans(lambda: render_rays(tracer, _rays(cam), **SOFT))
    (frame,) = _named(spans, "tpurt::render_rays")
    knear = _named(spans, "tpurt::walk.knear")
    assert len(knear) == 2 and all(_inside(k, frame) for k in knear)
    assert not _named(spans, "tpurt::walk.closest") and not _named(spans, "tpurt::area")


def test_soft_area_render_walks_its_candidates_inside_the_area_span():
    scene, cam = _scene()
    tracer = make_tracer(scene, "wide8", band=SOFT["band"])
    spans = _spans(lambda: render_rays(tracer, _rays(cam), light_samples=2,
                                       generator=_gen(), **SOFT))
    (area,) = _named(spans, "tpurt::area")
    (sample,) = _named(spans, "tpurt::area.sample")
    knear = _named(spans, "tpurt::walk.knear")
    assert len(knear) == 3 and _inside(sample, area)
    assert [_inside(k, area) for k in knear] == [False, False, True]


def _inverse(chunks=2, rebuild_every=1):
    scene, cam = _scene(width=6)
    fit = FitConfig(steps=1, lr=1e-3, grad_chunks=chunks, rebuild_every=rebuild_every)
    render = RenderConfig(method="wide8", **SOFT)
    target = torch.zeros((cam.num_pixels, 3))
    return InverseRenderer(scene, cam, fit=fit, render=render), target


def test_fit_step_spans_each_stage_once_and_each_chunk_twice():
    inv, target = _inverse()
    spans = _spans(lambda: inv.fit(target))
    count = {n: len(_named(spans, n)) for n in {s[0] for s in spans}}
    assert count == {"tpurt::fit.table": 1, "tpurt::refit": 1, "tpurt::fit.forward": 2,
                     "tpurt::render_rays": 2, "tpurt::walk.knear": 4,
                     "tpurt::fit.backward": 2, "tpurt::fit.update": 1,
                     "tpurt::fit.readback": 1, "tpurt::fit.rebuild_check": 1}
    order = [s[0] for s in spans if s[0] != "tpurt::walk.knear"]
    assert order == ["tpurt::fit.table", "tpurt::refit",
                     "tpurt::fit.forward", "tpurt::render_rays", "tpurt::fit.backward",
                     "tpurt::fit.forward", "tpurt::render_rays", "tpurt::fit.backward",
                     "tpurt::fit.update", "tpurt::fit.readback", "tpurt::fit.rebuild_check"]
    for fwd in _named(spans, "tpurt::fit.forward"):
        assert sum(_inside(r, fwd) for r in _named(spans, "tpurt::render_rays")) == 1
        assert sum(_inside(k, fwd) for k in _named(spans, "tpurt::walk.knear")) == 2


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)   # trace_span's
    scene, cam = _scene()
    rays = _rays(cam)
    hard = render_rays(make_tracer(scene, "wide8"), rays, light_samples=2, generator=_gen())
    soft = render_rays(make_tracer(scene, "wide8", band=SOFT["band"]), rays, light_samples=2,
                       generator=_gen(), **SOFT)
    inv, target = _inverse()
    res = inv.fit(target)
    assert bool(torch.isfinite(hard).all()) and bool(torch.isfinite(soft).all())
    assert res.steps_run == 1 and np.isfinite(res.losses[0])


def test_a_logged_span_logs_its_time_without_a_profiler(monkeypatch):
    lines = []
    monkeypatch.setattr(trace_mod, "_log", SimpleNamespace(
        info=lambda fmt, *args: lines.append(fmt % args)))
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with trace_span("render", log=True):
        torch.ones(4).sum()
    assert len(lines) == 1 and lines[0].startswith("span render: ")
