"""tpurt_torch's hard render against tpurt's reference images.

The goldens in tests/golden are tpurt's renders; tpurt's own tests hold its
engines to them with tests/golden/test_golden.py's _check, which this file
imports: frac 0.0 for brute, 0.003 for the BVH engines (wide8, bvh, binary,
packet, wave) and for the bunny image (itself a packet-engine render; the
port's "packet" engine meets it at tpurt's own frac 0.0 in
tests/test_torch_packet.py).
"""

import dataclasses

import pytest
import torch

from tests.golden.test_golden import _check
from tpurt_torch.core.math import to_uint8
from tpurt_torch.core.scene import make_bunny_scene, make_cornell_box
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render, render_rays


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engines' walks are lockstep loops of small
    tensor ops, which other test processes' threads slow down many times
    over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method,frac", [("brute", 0.0), ("wide8", 0.003), ("bvh", 0.003),
                                         ("binary", 0.003), ("packet", 0.003),
                                         ("wave", 0.003)])
def test_golden_cornell(method, frac):
    scene, cam = make_cornell_box(device="cpu")
    img = render(scene, dataclasses.replace(cam, width=64, height=64), method=method)
    _check(img, "cornell_brute_64.npy", frac=frac)


@pytest.mark.parametrize("method", ["packet", "wave"])
def test_golden_cornell_soft(method):
    """tpurt's soft golden through tpurt's own packet and wavefront engines,
    at its engine threshold (test_golden.py's test_golden_cornell_soft_engines;
    the other engines' soft goldens are in tests/test_torch_fit.py)."""
    scene, cam = make_cornell_box(device="cpu")
    img = render(scene, dataclasses.replace(cam, width=48, height=48), method=method,
                 soft=True, k_layers=4, sharpness=40.0, band=0.08)
    _check(img, "cornell_soft_48.npy", frac=0.003)


@pytest.mark.parametrize("method", ["brute", "wide8", "bvh", "binary"])
def test_golden_bunny(method):
    scene, cam = make_bunny_scene(num_tris=3000, device="cpu")
    img = render(scene, dataclasses.replace(cam, width=48, height=48), method=method)
    _check(img, "bunny3k_packet_48.npy", frac=0.003)


@pytest.mark.parametrize("soft", [False, True])
def test_binary_engine_renders_the_bvh_engines_image(soft):
    """The twins walk the packed tree in the flat tree's order: the same
    image, bit for bit, hard and soft."""
    scene, cam = make_bunny_scene(num_tris=3000, device="cpu")
    cam = dataclasses.replace(cam, width=32, height=32)
    kw = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08) if soft else {}
    img = {m: render(scene, cam, method=m, **kw) for m in ("bvh", "binary")}
    assert torch.equal(img["bvh"], img["binary"])
    assert float(img["bvh"].max()) > 0.0


def test_render_with_a_prebuilt_tracer_and_uint8():
    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=24, height=16)
    tracer = make_tracer(scene, "wide8")
    a = render(scene, cam, tracer=tracer)
    b = render(scene, cam, method="wide8")
    assert a.shape == (16, 24, 3) and torch.equal(a, b)
    img8 = to_uint8(a)
    assert img8.dtype == torch.uint8 and img8.shape == (16, 24, 3)


@pytest.mark.parametrize("kw,item", [
    (dict(soft=True, light_samples=2), "item 17"),
    (dict(spp=4, light_samples=2), "item 17"),
    (dict(light_samples=2), "item 17"),
])
def test_unported_options_raise(kw, item):
    """Area lights (ROADMAP item 17, which raised before it was ported)
    render: without a generator they sample nothing, as tpurt without a
    key; with one, cornell (no emitter) gets no area light either, and the
    image is the point-lit one."""
    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=4, height=4)
    point = render(scene, cam, **{k: v for k, v in kw.items() if k != "light_samples"})
    g = torch.Generator()
    g.manual_seed(0)
    for generator in (None, g):
        img = render(scene, cam, generator=generator, **kw)
        assert img.shape == (4, 4, 3) and bool(torch.isfinite(img).all())
        if kw.get("spp", 1) == 1:
            assert torch.equal(img, point)


def test_render_rays_soft_raises_and_method_checked():
    """The soft render of a flat ray batch is finite (R, 3) radiance; an
    unknown engine name is refused."""
    scene, cam = make_cornell_box(device="cpu")
    tracer = make_tracer(scene, "wide8", band=0.08)
    rays = gen_primary_rays(dataclasses.replace(cam, width=12, height=10))
    color = render_rays(tracer, rays, soft=True, k_layers=4, sharpness=40.0, band=0.08)
    assert color.shape == (120, 3) and bool(torch.isfinite(color).all())
    assert float(color.max()) > 0.0
    with pytest.raises(ValueError):
        make_tracer(scene, "pallas8")


def test_packet_engine_traces_row_major_packets(monkeypatch):
    """The packet engine's primary rays reach it in row-major pixel order,
    as tpurt traces them (its packets are runs of 1,024 consecutive rays);
    every other engine's in Morton order."""
    import tpurt_torch.render.pipeline as pipeline

    scene, cam = make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=8, height=4)
    row_major = gen_primary_rays(cam).d
    seen = {}

    def spy(tracer, rays, **kw):
        seen[tracer.method] = rays.d.clone()
        return torch.zeros_like(rays.d)

    monkeypatch.setattr(pipeline, "render_rays", spy)
    for method in ("packet", "binary"):
        render(scene, cam, method=method)
    assert torch.equal(seen["packet"], row_major)
    assert not torch.equal(seen["binary"], row_major)
    assert torch.equal(seen["binary"].sort(dim=0).values, row_major.sort(dim=0).values)
