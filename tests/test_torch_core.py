"""tpurt_torch core and camera against tpurt: procedural scenes bitwise,
primary rays within 1e-6, the Morton pixel permutation equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.core import scene as jscene
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays
from tpurt.render.camera import pixel_morton_perm as j_pixel_morton_perm

from tpurt_torch.core import scene as tscene
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm

SCENES = {
    "cornell": ("make_cornell_box", {}),
    "bunny3k": ("make_bunny_scene", {"num_tris": 3000}),
    "sponza20k": ("make_sponza_scene", {"num_tris": 20_000}),
}


def _both(name):
    fn, kw = SCENES[name]
    return getattr(jscene, fn)(**kw), getattr(tscene, fn)(**kw, device="cpu")


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_bitwise(name):
    (js, jc), (ts, tc) = _both(name)
    for field in ("verts", "faces", "albedo", "emission"):
        a, b = np.asarray(getattr(js.tris, field)), getattr(ts.tris, field).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(_bits(a), _bits(b)), field
    for a, b in ((js.lights.pos, ts.lights.pos),
                 (js.lights.intensity, ts.lights.intensity),
                 (js.background, ts.background), (js.ambient, ts.ambient),
                 (jc.eye, tc.eye), (jc.target, tc.target), (jc.up, tc.up),
                 (jc.fov_y_deg, tc.fov_y_deg)):
        assert np.array_equal(_bits(a), _bits(b.numpy()))
    assert (jc.width, jc.height) == (tc.width, tc.height)


def test_get_scene_names():
    s, c = tscene.get_scene("cornell", device="cpu")
    assert s.num_tris == 30 and c.width == 256
    with pytest.raises(ValueError):
        tscene.get_scene("no-such-scene")


@pytest.mark.parametrize("name,size,jitter", [
    ("cornell", (64, 64), False),
    ("sponza20k", (96, 54), False),
    ("bunny3k", (40, 24), True),
])
def test_gen_primary_rays_close(name, size, jitter):
    """tan/normalize may round differently in XLA and torch: within 1e-6."""
    (_, jc), (_, tc) = _both(name)
    w, h = size
    jc = jc.replace(width=w, height=h)
    tc = dataclasses.replace(tc, width=w, height=h)
    jit = None
    if jitter:
        jit = np.random.default_rng(4).uniform(0, 1, (w * h, 2)).astype(np.float32)
    jr = j_gen_primary_rays(jc, None if jit is None else jnp.asarray(jit))
    tr = gen_primary_rays(tc, None if jit is None else torch.from_numpy(jit))
    assert tuple(tr.o.shape) == (w * h, 3) and tuple(tr.d.shape) == (w * h, 3)
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), rtol=0, atol=1e-6)


@pytest.mark.parametrize("h,w", [(64, 64), (1088, 1920), (7, 13)])
def test_pixel_morton_perm_equal(h, w):
    jp, ji = j_pixel_morton_perm(h, w)
    tp, ti = pixel_morton_perm(h, w)
    assert np.array_equal(jp, tp) and np.array_equal(ji, ti)
    assert np.array_equal(tp[ti], np.arange(h * w))


def test_convert_round_trip():
    js, jc = jscene.make_cornell_box()
    s = scene_from_numpy(
        verts=np.asarray(js.tris.verts), faces=np.asarray(js.tris.faces),
        albedo=np.asarray(js.tris.albedo), emission=np.asarray(js.tris.emission),
        light_pos=np.asarray(js.lights.pos),
        light_intensity=np.asarray(js.lights.intensity),
        background=np.asarray(js.background), ambient=np.asarray(js.ambient),
        device="cpu")
    ts, tc = tscene.make_cornell_box(device="cpu")
    for a, b in ((s.tris.verts, ts.tris.verts), (s.tris.faces, ts.tris.faces),
                 (s.tris.albedo, ts.tris.albedo), (s.lights.pos, ts.lights.pos),
                 (s.background, ts.background)):
        assert np.array_equal(a.numpy(), b.numpy())
    c = camera_from_numpy(eye=np.asarray(jc.eye), target=np.asarray(jc.target),
                          up=np.asarray(jc.up), fov_y_deg=np.asarray(jc.fov_y_deg),
                          width=jc.width, height=jc.height, device="cpu")
    assert np.array_equal(gen_primary_rays(c).d.numpy(), gen_primary_rays(tc).d.numpy())
