"""tpurt_torch's hard render against tpurt's reference images.

The goldens in tests/golden are tpurt's renders; tpurt's own tests hold its
engines to them with tests/golden/test_golden.py's _check, which this file
imports: frac 0.0 for brute, 0.003 for the wide8 engine and for the bunny
image (itself a packet-engine render).
"""

import dataclasses

import pytest
import torch

from tests.golden.test_golden import _check
from tpurt_torch.core.math import to_uint8
from tpurt_torch.core.scene import make_bunny_scene, make_cornell_box
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render, render_rays


@pytest.mark.parametrize("method,frac", [("brute", 0.0), ("wide8", 0.003)])
def test_golden_cornell(method, frac):
    scene, cam = make_cornell_box(device="cpu")
    img = render(scene, dataclasses.replace(cam, width=64, height=64), method=method)
    _check(img, "cornell_brute_64.npy", frac=frac)


@pytest.mark.parametrize("method", ["brute", "wide8"])
def test_golden_bunny(method):
    scene, cam = make_bunny_scene(num_tris=3000, device="cpu")
    img = render(scene, dataclasses.replace(cam, width=48, height=48), method=method)
    _check(img, "bunny3k_packet_48.npy", frac=0.003)


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
    (dict(spp=4), "item 17"),
    (dict(light_samples=2), "item 17"),
])
def test_unported_options_raise(kw, item):
    scene, cam = make_cornell_box(device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        render(scene, dataclasses.replace(cam, width=4, height=4), **kw)


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
