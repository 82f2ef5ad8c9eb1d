"""The dist paths at world 4: test_torch_dist_ring.py's ring and
alltoall cases against tpurt's ring on make_mesh(jax.devices()[:4]) (the
packet ring on its groups input, 1 packet a rank here), and
Renderer(mesh=...) in spawned gloo ranks against the port's render in this
process: the replicated render (rays sharded) bitwise, the ring by tpurt's
image rule (tests/dist/test_api_partition.py: at most 0.3% of pixels off by
more than 2e-3), hard through both ring engines and soft (within 1e-5);
'auto' picks 'replicated' for a small scene."""

import numpy as np
import pytest

from tests.dist_ranks import alltoall_cases, np_tree, renderer_cases, ring_cases
from tests.test_torch_dist_partition import np_cam, np_scene, np_tris
from tests.test_torch_dist_ring import (  # noqa: F401  (collected here at world 4)
    BAND, K, SPAWN_TIMEOUT, group_cases, groups, inputs,
    test_alltoall_overflow_left_unresolved, test_alltoall_trace_resolved_rays,
    test_p10_binary_ring_misses_p1_rays_packet_ring_does_not, test_ring_k_nearest,
    test_ring_occluded, test_ring_trace, tpurt_ring)
from tpurt.core.scene import make_bunny_scene as j_make_bunny_scene
from tpurt.core.scene import make_cornell_box as j_make_cornell_box

from tpurt_torch.api.config import RenderConfig
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.dist.dryrun import run_ranks

SOFT = dict(soft=True, sharpness=30.0, band=0.2, k_layers=4)
IMAGE_ATOL, IMAGE_MAX_OFF = 2e-3, 0.003


@pytest.fixture(scope="module")
def world():
    return 4


@pytest.fixture(scope="module")
def scenes():
    js, jc = j_make_bunny_scene(num_tris=2000)
    cs, cc = j_make_cornell_box()
    return (np_scene(js), np_cam(jc.replace(width=40, height=24)),
            np_scene(cs), np_cam(cc.replace(width=12, height=12)))


def _cases(mesh, tris, o, d, tmax, group_input, scenes):
    return {"ring": ring_cases(mesh, tris, o, d, tmax, K, BAND),
            "groups": group_cases(mesh, group_input),
            "alltoall": alltoall_cases(mesh, tris, o, d),
            "renderer": renderer_cases(mesh, *scenes, SOFT)}


@pytest.fixture(scope="module")
def port(world, inputs, groups, scenes):
    jt, o, d, tmax = inputs
    gt, go, gd, gtmax, _ = groups
    out = run_ranks(_cases, world, np_tris(jt), o, d, tmax, (np_tris(gt), go, gd, gtmax),
                    scenes, device="cpu", timeout=SPAWN_TIMEOUT)
    return [np_tree(x) for x in out]


def _single(scene, cam, cfg):
    return Renderer(scene_from_numpy(**scene, device="cpu"), cfg).render(
        camera_from_numpy(**cam, device="cpu")).numpy()


@pytest.mark.parametrize("method", ["wide8", "binary"])
def test_renderer_ring_and_replicated_on_the_mesh(port, scenes, method):
    scene, cam, _, _ = scenes
    ref = _single(scene, cam, RenderConfig(method=method))
    for rank in port:
        r = rank["renderer"]
        assert np.array_equal(r[f"replicated_{method}"], ref)
        ring = r[f"ring_{method}"]
        assert ring.shape == ref.shape == (24, 40, 3) and np.isfinite(ring).all()
        off = (np.abs(ring - ref).max(axis=-1) > IMAGE_ATOL).mean()
        assert off <= IMAGE_MAX_OFF, f"{off} of pixels differ"
        assert np.array_equal(ring, port[0]["renderer"][f"ring_{method}"])


def test_renderer_ring_soft_and_auto(port, scenes):
    _, _, scene, cam = scenes
    ref = _single(scene, cam, RenderConfig(method="wide8", **SOFT))
    for rank in port:
        r = rank["renderer"]
        assert r["auto_partition"] == "replicated"
        np.testing.assert_allclose(r["soft_replicated"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["soft_ring"], ref, rtol=1e-5, atol=1e-5)
