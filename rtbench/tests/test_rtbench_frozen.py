"""The frozen yardstick equals what users get today: the courtyard's and the
bunny's arrays bitwise the port's generators, the camera rays bitwise the
port's."""

import numpy as np
import pytest
import torch

from rtbench.frozen import camera, scene, views
from rtbench.scenes import bunny


def _assert_bitwise(a, port):
    for got, want in ((a.verts, port.tris.verts), (a.faces, port.tris.faces),
                      (a.albedo, port.tris.albedo), (a.emission, port.tris.emission),
                      (a.light_pos, port.lights.pos), (a.light_intensity, port.lights.intensity),
                      (a.background, port.background), (a.ambient, port.ambient)):
        want = want.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("num_tris", [1, 3000, 20_000])
def test_scene_arrays_bitwise_the_ports(num_tris):
    from tpurt_torch.core.scene import make_sponza_scene

    port, _ = make_sponza_scene(num_tris=num_tris, seed=7, device="cpu")
    _assert_bitwise(scene.sponza_arrays(num_tris, 7), port)


@pytest.mark.parametrize("num_tris,made", [(200, 202), (5_000, 5_002), (70_000, 69_940)])
def test_bunny_arrays_bitwise_the_ports(num_tris, made):
    """The port's generator draws the knot's bumps with seed 0."""
    from tpurt_torch.core.scene import make_bunny_scene

    port, _ = make_bunny_scene(num_tris=num_tris, device="cpu")
    a = bunny.arrays(num_tris, 0)
    assert a.num_tris == made
    _assert_bitwise(a, port)
    assert not np.array_equal(bunny.arrays(num_tris, 1).verts, a.verts)


@pytest.mark.parametrize("eye,target,size", [
    ((0.0, 22.0, 26.0), (0.0, 1.5, 0.0), (40, 24)),
    ((3.5, 1.7, -2.25), (4.1, 1.5, -2.0), (33, 17)),
    ((0.0, 4.5, 16.5), (0.0, 2.0, 0.0), (64, 48))])
def test_camera_rays_bitwise_the_ports(eye, target, size):
    from tpurt_torch.core.geometry import Camera
    from tpurt_torch.render.camera import gen_primary_rays

    w, h = size
    rays = gen_primary_rays(Camera.create(eye=eye, target=target, fov_y_deg=50.0, width=w,
                                          height=h, device="cpu"))
    o, d = camera.primary_rays(camera.View.create(eye, target, 50.0, w, h, "cpu"))
    assert torch.equal(o, rays.o) and torch.equal(d, rays.d)


def test_emitters_are_a_seeded_choice():
    a = scene.sponza_arrays(3000, 7)
    e = scene.with_emitters(a, 64, 8.0, 11)
    lit = np.flatnonzero(e.emission[:, 0])
    assert lit.size == 64 and np.all(e.emission[lit] == 8.0)
    assert np.array_equal(lit, np.flatnonzero(scene.with_emitters(a, 64, 8.0, 11).emission[:, 0]))


def test_views_same_set_for_every_seed():
    spec = [{"kind": "walk", "count": 3, "radius": 12.0, "height": 1.7, "pitch_deg": [0, 15]},
            {"kind": "orbit", "count": 2, "radius": 26.0, "height": 22.0, "target": [0, 1.5, 0]}]
    v = views.make_views(spec, 32)
    assert v == views.make_views(spec, 32) and len(v) == 5
    assert all(abs(e[1] - 1.7) < 1e-12 for e, _ in v[:3])
    a, b = views.cycle_order(5, 32, 1), views.cycle_order(5, 32, 2 ** 31 + 5)
    assert sorted(a) == list(range(5))
    assert any(np.array_equal(np.roll(a, k), b) for k in range(5))
    seeds = views.frame_seeds(2 ** 40 + 3)
    assert seeds(0) != seeds(1) and 0 <= seeds(7) < 2 ** 62
