"""The any-hit kernels' design (csrc/traverse8.cu occluded8_walk,
csrc/traverse.cu occluded_bin_walk) held to the plain-torch twins, to the
escape-order oracle and to the parent's visit order.

The CUDA kernels cannot run here, so their loops are rendered one ray at a
time in numpy float32, statement for statement (tests/walk_loops.py):
occluded8's entry-order pushes, its flat loop over a visit's rows and its
half-row tests that end the walk at the first half row that blocks;
occluded_bin's near-first walk with the fixed bound t_max (both children
tested, the nearer entered, the farther pushed), its while-while descents
and half-row leaves.  Each rendering must return the twin's flag on every
ray and walk exactly the twin's visits and half rows, which the kernels'
bounds are computed from.

The any-hit flag does not depend on the visit order: the window (t_min,
t_max) never shrinks, so the leaves a ray tests are the same in any order,
and a walk ends only once the flag is true.  So the near-first twin of
occluded_bin must give the escape walk's flag (accel/traverse_ref.py
occluded_walk, the parent's order) on every ray, and the BVH8 twin the same
flags over its own tree.

The rays: bunny-3K's special rays (test_torch_traverse8.py) with their
t_max groups, and the primary rays of a 20K-triangle sponza view and of
cornell at 32^2, each given a t_max from its closest hit: empty windows
(t_max <= t_min), windows that end short of every hit and windows that
hold one; plus, in every case, rays shot point-blank at triangles, which
the walks must find blocked in their first leaf.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_torch_traverse8 import _bunny_rays, _trays
from tests.walk_loops import T_MIN, occluded8_kernel_loop, occluded_bin_kernel_loop
from tpurt_torch.accel.bvh8 import build_wide
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.accel.traverse_ref import occluded_walk
from tpurt_torch.core.geometry import Rays, Triangles
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels import traverse8 as k8

f32 = np.float32
POINT_BLANK = 48


def _point_blank(tris: Triangles, rng) -> tuple:
    """POINT_BLANK rays from 0.01 off random triangles' centroids along
    their normals (either side), aimed back at them, t_max 1: each is
    blocked, by its own triangle if by nothing nearer."""
    pick = rng.choice(tris.num_tris, POINT_BLANK, replace=tris.num_tris < POINT_BLANK)
    v0, v1, v2 = (c[pick].numpy() for c in tris.corners())
    nrm = np.cross(v1 - v0, v2 - v0)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm *= rng.choice([-1.0, 1.0], (POINT_BLANK, 1))
    o = (v0 + v1 + v2) / 3 + 0.01 * nrm
    return o.astype(f32), (-nrm).astype(f32), np.ones(POINT_BLANK, f32)


def _case(tris: Triangles, o, d, tmax, rng) -> dict:
    """The rays, the point-blank group appended, and the port's hard trees."""
    po, pd, pt = _point_blank(tris, rng)
    bvh = build_lbvh(tris)
    return dict(o=np.concatenate([o, po]), d=np.concatenate([d, pd]),
                tmax=np.concatenate([tmax, pt]), wide=build_wide(tris, bvh),
                packed=pack_bvh(tris, bvh, max_cut_leaves(tris.num_tris, bvh.leaf_size)))


def _view(make, res: int, rng) -> dict:
    """A scene's primary rays at res^2, each with a t_max from its closest
    hit t_hit: t_hit * U(-0.2, 2) for a hit (empty, short and holding
    windows), U(-1, 50) for a miss; t_hit is kept for the test."""
    from tpurt_torch.render.camera import gen_primary_rays

    sc, cam = make()
    rays = gen_primary_rays(dataclasses.replace(cam, width=res, height=res))
    o, d = rays.o.reshape(-1, 3).numpy(), rays.d.reshape(-1, 3).numpy()
    bvh = build_lbvh(sc.tris)
    hit = kb.traverse_packed_ref(_trays(o, d), pack_bvh(
        sc.tris, bvh, max_cut_leaves(sc.tris.num_tris, bvh.leaf_size)))
    t_hit, ok = hit.t.numpy(), hit.tri.numpy() >= 0
    tmax = np.where(ok, t_hit * rng.uniform(-0.2, 2.0, ok.shape),
                    rng.uniform(-1.0, 50.0, ok.shape)).astype(f32)
    case = _case(sc.tris, o, d, tmax, rng)
    case["t_hit"] = np.concatenate([np.where(ok, t_hit, np.inf), np.zeros(POINT_BLANK)])
    return case


@pytest.fixture(scope="module")
def views():
    """name -> rays, t_max and trees: bunny-3K's special rays (every 4th of
    the 64^2 frame, every special group kept), a 32^2 view of a 20K-triangle
    sponza (an interior, where many boxes overlap along a ray) and cornell
    at 32^2."""
    from tpurt_torch.core.scene import make_cornell_box, make_sponza_scene

    rng = np.random.default_rng(11)
    jt, o, d, tmax, groups = _bunny_rays()
    keep = np.zeros(o.shape[0], bool)
    keep[::4] = True
    for g in groups.values():
        keep[g] = True
    tris = Triangles.create(np.asarray(jt.verts), np.asarray(jt.faces), device="cpu")
    return {"bunny3k": _case(tris, o[keep], d[keep], tmax[keep], rng),
            "sponza20k": _view(lambda: make_sponza_scene(num_tris=20_000, device="cpu"), 32,
                               rng),
            "cornell": _view(lambda: make_cornell_box(device="cpu"), 32, rng)}


NAMES = ["bunny3k", "sponza20k", "cornell"]


def _rays(v):
    return _trays(v["o"], v["d"]), torch.from_numpy(v["tmax"])


def _check_flags(flags, v):
    """Some rays blocked and some not; every point-blank ray blocked, and no
    empty window."""
    assert 0.05 < flags.mean() < 0.95
    assert flags[-POINT_BLANK:].all()
    assert not flags[v["tmax"] <= T_MIN].any()


@pytest.mark.parametrize("name", NAMES)
def test_occluded8_kernel_loop_matches_the_twin(views, name):
    """The occluded8 loop returns the twin's flag on every ray, walks the
    twin's visits and half rows, never holds more on its stack than the
    topology's bound, and finds rays blocked in the first row they test."""
    v = views[name]
    flags, counts, deepest, first = occluded8_kernel_loop(v["wide"], v["o"], v["d"], v["tmax"])
    rays, tmax = _rays(v)
    stats = {}
    twin = k8.occluded_wide8_ref(rays, v["wide"], tmax, stats=stats).numpy()
    assert np.array_equal(flags, twin)
    assert counts == k8.walk_counts(stats)
    _check_flags(flags, v)
    assert deepest <= v["wide"].max_stack <= k8.STACKV
    assert (deepest > 0) == (v["wide"].num_wides > 1)  # cornell's is one node
    assert first > 0


@pytest.mark.parametrize("name", NAMES)
def test_occluded_bin_kernel_loop_matches_the_twin(views, name):
    """The occluded_bin loop returns the twin's flag on every ray, walks the
    twin's slab tests and half rows, its stack never holds more than the
    tree is deep, and the point-blank rays end in their first leaf."""
    v = views[name]
    flags, counts, deepest, first = occluded_bin_kernel_loop(v["packed"], v["o"], v["d"],
                                                             v["tmax"])
    rays, tmax = _rays(v)
    stats = {}
    twin = kb.occluded_packed_ref(rays, v["packed"], tmax, stats=stats).numpy()
    assert np.array_equal(flags, twin)
    assert counts == k8.walk_counts(stats)
    _check_flags(flags, v)
    assert 0 < deepest <= v["packed"].depth <= kb.BIN_STACK
    assert first >= POINT_BLANK // 2


@pytest.mark.parametrize("name", NAMES)
def test_any_hit_twins_match_the_escape_oracle_and_the_parent_order(views, name):
    """The flag does not depend on the visit order: occluded_bin's near-first
    twin, the escape walk over the same packed tree (the parent's order) and
    the BVH8 twin over its own tree give the same flag on every ray, while
    the two binary walks walk differently.  Where t_hit is known, a window
    that ends at or before the closest hit is never blocked and one that
    holds it always is."""
    v = views[name]
    rays, tmax = _rays(v)
    near, escape = {}, {}
    a = kb.occluded_packed_ref(rays, v["packed"], tmax, stats=near).numpy()
    b = occluded_walk(rays, kb.PackedLayout(v["packed"]), tmax, stats=escape).numpy()
    c = k8.occluded_wide8_ref(rays, v["wide"], tmax).numpy()
    assert np.array_equal(a, b) and np.array_equal(a, c)
    _check_flags(a, v)
    assert k8.walk_counts(near) != k8.walk_counts(escape)
    if "t_hit" in v:
        live = v["tmax"] > T_MIN
        short, holds = live & (v["tmax"] <= v["t_hit"]), live & (v["tmax"] > v["t_hit"])
        assert short.sum() > 50 and holds.sum() > 50
        assert not a[short].any() and a[holds].all()


@pytest.mark.parametrize("kernel", ["occluded8", "occluded_bin"])
def test_walk_ab_fails_every_differing_flag(kernel):
    """[walk_ab] has no explanation for an any-hit ray: each flag that
    differs from another tree's is printed and counted unexplained."""
    packed = _one_leaf_tree()
    rays = Rays(o=torch.zeros((3, 3)), d=torch.ones((3, 3)))
    new = (torch.tensor([1, 0, 1], dtype=torch.uint8),)
    other = (torch.tensor([1, 1, 0], dtype=torch.uint8),)
    assert chip_smoke.differing_rays("cell", kernel, packed, "parent", rays, new, other) == 2
    assert chip_smoke.differing_rays("cell", kernel, packed, "parent", rays, new, new) == 0


def _one_leaf_tree():
    """A one-triangle packed tree (differing_rays reads the tree only for
    closest_bin)."""
    tris = Triangles.create(np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], f32),
                            np.array([[0, 1, 2]]), device="cpu")
    bvh = build_lbvh(tris)
    return pack_bvh(tris, bvh, max_cut_leaves(1, bvh.leaf_size))


def test_any_hit_bounds_count_half_rows():
    """chip_smoke.py's bound takes the any-hit twins' rows as half rows: 4
    Möller–Trumbore tests each, where a closest-hit row has 8."""
    counts = dict(visits=10, rows=6, distinct_nodes=2, distinct_rows=3)
    for half, full in ((chip_smoke.WIDE_HALF, chip_smoke.WIDE),
                       (chip_smoke.BIN_HALF, chip_smoke.BIN)):
        slabs = full["slabs"] * chip_smoke.SLAB_OPS * 10
        assert chip_smoke.bound(counts, 1, 0, 0, half)["ops"] == slabs + 4 * chip_smoke.MT_OPS * 6
        assert chip_smoke.bound(counts, 1, 0, 0, full)["ops"] == slabs + 8 * chip_smoke.MT_OPS * 6
