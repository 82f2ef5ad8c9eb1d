"""The data-parallel fit, ray sharding and the runtime at world 2 (spawned
gloo ranks), against the port in this process; and the dry run.

- InverseRenderer(mesh=...) at world 2 with grad_chunks 2, 2 Adam steps,
  against the single-process fit (grad_chunks 1), tpurt's
  tests/dist/test_fit_dp.py: losses, vertices and albedo within rtol 1e-4
  (the sums run in another order); exactly grad_chunks all-reduces a step,
  of 60 T + 4 bytes each (the chunk's table gradient and its loss).
- chunked_grad against a plain gradient, without a mesh and over the mesh.
- shard_render at world 2 equals the render in the rank's own process
  bitwise per pixel, hard, soft and on a ragged batch (1201 rays).
- init_distributed through a file:// rendezvous, is_coordinator,
  psum_tree, pmean_tree, all_gather_tree, ppermute_tree and gather_film
  (tpurt's tests/dist/test_multihost.py).
- python -m tpurt_torch.dist.dryrun at 2 ranks (its partitioned fit step
  through the ring's "packet" and "binary" engines).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.dist_ranks import chunked_grad_cases, fit_cases, np_tree, runtime_cases, shard_cases
from tests.test_torch_dist_partition import np_cam, np_scene
from tpurt.core.scene import make_cornell_box as j_make_cornell_box

from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.geometry import Rays
from tpurt_torch.dist import dryrun
from tpurt_torch.dist.collectives import chunked_grad
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render, render_rays, tri_table

WORLD, STEPS, CHUNKS = 2, 2, 2
RKW = dict(method="bvh", soft=True, k_layers=4, sharpness=40.0, band=0.15)
SOFT = dict(soft=True, k_layers=4, sharpness=40.0, band=0.15)
SPAWN_TIMEOUT = 300.0


@pytest.fixture(scope="module")
def problem():
    """tpurt's DP-fit problem: cornell 32^2, the target rendered from the
    scene, the vertices scaled by 1.02."""
    js, jc = j_make_cornell_box()
    scene = np_scene(js)
    cam = np_cam(jc.replace(width=32, height=32))
    sc, cm = scene_from_numpy(**scene, device="cpu"), camera_from_numpy(**cam, device="cpu")
    with torch.no_grad():
        target = render(sc, cm, **RKW).numpy()
    pert = dict(scene, verts=scene["verts"] * np.float32(1.02))
    return pert, cam, target


def _cases(mesh, pert, cam, target, shard_cam):
    return {"fit": fit_cases(mesh, pert, cam, target, RKW, STEPS, CHUNKS),
            "grad": chunked_grad_cases(mesh, pert, cam, RKW, CHUNKS),
            "shard": shard_cases(mesh, pert, shard_cam, 1201, SOFT),
            "runtime": runtime_cases(mesh)}


@pytest.fixture(scope="module")
def port(problem):
    pert, cam, target = problem
    shard_cam = dict(cam, width=40, height=40)
    return [np_tree(x) for x in run(_cases, pert, cam, target, shard_cam)]


def run(fn, *args):
    return dryrun.run_ranks(fn, WORLD, *args, device="cpu", timeout=SPAWN_TIMEOUT)


def test_dp_fit_matches_single_process(port, problem):
    pert, cam, target = problem
    sc, cm = scene_from_numpy(**pert, device="cpu"), camera_from_numpy(**cam, device="cpu")
    ref = InverseRenderer(sc, cm, fit=FitConfig(steps=STEPS, lr=1e-3, grad_chunks=1),
                          render=RenderConfig(**RKW)).fit(torch.from_numpy(target))
    for rank in port:
        got = rank["fit"]
        np.testing.assert_allclose(got["losses"], ref.losses, rtol=1e-4)
        np.testing.assert_allclose(got["verts"], ref.params["verts"].numpy(), rtol=1e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(got["albedo"], ref.params["albedo"].numpy(), rtol=1e-4,
                                   atol=1e-6)
        assert np.array_equal(got["verts"], port[0]["fit"]["verts"])
    assert ref.losses[-1] < ref.losses[0]


def test_dp_fit_one_all_reduce_per_chunk(port, problem):
    n_tris = problem[0]["faces"].shape[0]
    for rank in port:
        assert rank["fit"]["counts"] == [
            {"all_reduce": CHUNKS, "all_reduce_bytes": CHUNKS * (60 * n_tris + 4)}] * STEPS


def test_chunked_grad_matches_plain_grad(port, problem):
    """Over the mesh (each rank its half of the rays, 2 chunks) and without
    one (4 chunks), against one autograd.grad of the whole batch."""
    pert, cam, _ = problem
    sc, cm = scene_from_numpy(**pert, device="cpu"), camera_from_numpy(**cam, device="cpu")
    tracer = make_tracer(sc, "bvh", band=RKW["band"])
    rays = gen_primary_rays(cm)
    rkw = {k: v for k, v in RKW.items() if k != "method"}
    verts = sc.tris.verts.clone().requires_grad_(True)

    def loss(v, o, d):
        tr = dataclasses.replace(tracer, table=tri_table(dataclasses.replace(sc.tris, verts=v)))
        return torch.sum(render_rays(tr, Rays(o=o, d=d), **rkw) ** 2)

    ref_l = loss(verts, rays.o, rays.d)
    (ref_g,) = torch.autograd.grad(ref_l, verts)
    ref_l = float(ref_l.detach())
    l4, g4 = chunked_grad(loss, verts, (rays.o, rays.d), 4)
    np.testing.assert_allclose(float(l4), ref_l, rtol=1e-5)
    np.testing.assert_allclose(g4.numpy(), ref_g.numpy(), rtol=1e-4, atol=1e-6)
    l2, g2 = chunked_grad(lambda p, o, d: loss(p["v"], o, d), {"v": verts},
                          (rays.o, rays.d), 2)
    np.testing.assert_allclose(float(l2), ref_l, rtol=1e-5)
    np.testing.assert_allclose(g2["v"].numpy(), ref_g.numpy(), rtol=1e-4, atol=1e-6)
    for rank in port:
        g = rank["grad"]
        np.testing.assert_allclose(float(g["loss"]), ref_l, rtol=1e-5)
        np.testing.assert_allclose(g["grad"], ref_g.numpy(), rtol=1e-4, atol=1e-6)
        assert g["counts"]["all_reduce"] == CHUNKS


@pytest.mark.parametrize("case", ["hard", "ragged", "soft"])
def test_shard_render_bitwise(port, case):
    for rank in port:
        s = rank["shard"]
        assert s[case].shape == s[f"{case}_ref"].shape
        assert np.array_equal(s[case], s[f"{case}_ref"]), case
    assert port[0]["shard"]["ragged"].shape == (1201, 3)


def test_runtime_across_two_processes(port):
    shards = [np.arange(6, dtype=np.float32).reshape(2, 3) + 100 * r for r in range(WORLD)]
    for r, rank in enumerate(port):
        rt = rank["runtime"]
        assert rt["world"] == WORLD and rt["coordinator"] == (r == 0)
        assert rt["psum"].tolist() == [3.0] and rt["pmean"].tolist() == [1.5]
        assert np.array_equal(rt["gathered"]["s"], np.concatenate(shards))
        assert rt["gathered"]["f"].tolist() == [True, True, False, True]
        assert np.array_equal(rt["rotated"]["s"], shards[(r - 1) % WORLD])
        assert rt["rotated"]["f"].tolist() == [(r - 1) % 2 == 0, True]
        if r == 0:
            assert np.array_equal(rt["film"], np.concatenate(shards))
        else:
            assert rt["film"] is None


def test_dryrun_two_ranks():
    out = dryrun.run_ranks(dryrun.dryrun, 2, "cpu", 20_000, 32, 16, device="cpu",
                           timeout=SPAWN_TIMEOUT)
    assert len(out) == 2 and out[0] == out[1]
    assert out[0]["ring"]["off_frac"] <= 0.003
    fits = out[0]["partitioned_fit"]
    assert set(fits) == {"packet", "binary"} and all(f["moved"] > 0 for f in fits.values())
