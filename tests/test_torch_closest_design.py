"""The closest-hit kernels' design (csrc/traverse8.cu closest8_walk,
csrc/traverse.cu closest_bin_walk) held to the plain-torch twins and to the
parent's visit order.

The CUDA kernels cannot run here, so their loops are rendered one ray at a
time in numpy float32, statement for statement: closest8's entry-order
pushes, its flat loop over a visit's rows, its half-row tests and the
shading lanes read once for the winner after the walk; closest_bin's
near-first walk (tests/walk_loops.py: both children tested, the
nearer entered, the farther pushed with its t_near, pops culled against the
best hit) with its while-while descents and half-row leaves.  Each
rendering must return the twin's (t, u, v, id) and shading lanes bit for
bit and walk exactly the twin's visits and rows, which the kernels' bounds
are computed from.  The rays are test_torch_traverse8.py's bunny-3K rays
with their special groups, and a small sponza view; the trees are the
port's own builds.

Also here: closest_bin's near-first twin against the parent's escape walk
(the same outputs on every ray), the near-first walks' stack-depth check
on a deep chain (closest_bin's and occluded_bin's), the one way closest_bin's
ids can differ from the parent's (ROADMAP P6) and the rule by which
chip_smoke.py's [walk_ab] lets such a ray pass, and the rule that every
kernel launch is made on its tensors' card (P5).
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from tests.launch_scan import launches_outside_on_device as _launches_outside_on_device
from tests.walk_loops import END, T_MIN, Best, closest_bin_kernel_loop
from tests.test_torch_knear_design import KernelStack, _cuda_const
from tests.test_torch_traverse8 import _bunny_rays, _trays
from tpurt_torch.accel.bvh8 import build_wide, decode_lane_i32
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import LEAF_CAP, PackedBVH, max_cut_leaves, pack_bvh, tree_depth
from tpurt_torch.accel.traverse_ref import closest_walk, occluded_walk, safe_inv
from tpurt_torch.core.geometry import Rays, Triangles
from tpurt_torch.kernels import _build
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels import traverse8 as k8

f32 = np.float32
BIN_STACK = _cuda_const("traverse.cu", "kBinStack")


def test_twins_follow_the_kernels_constants():
    assert kb.BIN_STACK == BIN_STACK
    assert kb._END == END


def _closest8_kernel_loop(wide, o, d):
    """traverse8.cu's closest8_walk, one ray at a time: returns (t, u, v,
    id, shading lanes (N, 9)), the walk counts and the deepest stack."""
    nodes = wide.wrow.reshape(-1, 64)
    box = nodes[:, :48].numpy().reshape(-1, 8, 6)
    meta_all = decode_lane_i32(nodes.view(torch.int32)[:, 48:56]).numpy()
    trows = wide.tri_rows.numpy()
    tids = decode_lane_i32(wide.tri_rows.view(torch.int32)[:, 72:80]).numpy()
    inv_all = safe_inv(torch.from_numpy(d)).numpy()
    n = o.shape[0]
    out = [np.zeros(n, f32) for _ in range(3)] + [np.full(n, -1, np.int32),
                                                  np.zeros((n, 9), f32)]
    counts = {"visits": 0, "rows": 0}
    seen_n, seen_r, deepest = set(), set(), 0
    for i in range(n):
        inv, oi, b = inv_all[i], o[i] * inv_all[i], Best()
        st, cur = KernelStack(), 0
        while cur >= 0:
            counts["visits"] += 1
            seen_n.add(cur)
            bx = box[cur]
            with np.errstate(over="ignore", invalid="ignore"):  # empty slots: 3e38
                t0, t1 = bx[:, :3] * inv - oi, bx[:, 3:] * inv - oi
            near = np.maximum(np.minimum(t0, t1).max(axis=1), T_MIN)
            far = np.minimum(np.maximum(t0, t1).min(axis=1), b.t)
            meta = meta_all[cur]
            passing = [c for c in range(8) if near[c] <= far[c]]
            for c in passing:
                if meta[c] >= 0:
                    st.push(int(meta[c]))
            deepest = max(deepest, st.sp)
            cur = st.pop()
            for c in passing:  # one flat loop over the passing leaves' rows
                if meta[c] >= 0:
                    continue
                nm = ~int(meta[c])
                for row in range(nm >> 3, (nm >> 3) + max(0, min((nm & 7) + 1, wide.max_rows))):
                    counts["rows"] += 1
                    seen_r.add(row)
                    tri9 = trows[row, :72].reshape(8, 9)
                    for h in (0, 1):
                        b.half(tri9[4 * h:4 * h + 4], tids[row, 4 * h:4 * h + 4], o[i], d[i],
                               lambda j, row=row, h=h: (row, 4 * h + j))
        out[0][i], out[1][i], out[2][i], out[3][i] = b.t, b.u, b.v, b.id
        if b.win is not None:  # the shading lanes, read once after the walk
            tr, j = trows[b.win[0]], b.win[1]
            e1x, e1y, e1z, e2x, e2y, e2z = tr[9 * j + 3:9 * j + 9]
            out[4][i] = np.concatenate([tr[80 + 3 * j:83 + 3 * j], tr[104 + 3 * j:107 + 3 * j],
                                        [e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                                         e1x * e2y - e1y * e2x]])
    counts.update(distinct_nodes=len(seen_n), distinct_rows=len(seen_r))
    return out, counts, deepest


def _trees(tris):
    bvh = build_lbvh(tris)
    return build_wide(tris, bvh), pack_bvh(tris, bvh, max_cut_leaves(tris.num_tris,
                                                                      bvh.leaf_size))


@pytest.fixture(scope="module")
def scene():
    """bunny-3K's special rays (every 4th of the 64^2 frame, every special
    group kept) and the port's hard trees."""
    jt, o, d, tmax, groups = _bunny_rays()
    keep = np.zeros(o.shape[0], bool)
    keep[::4] = True
    for g in groups.values():
        keep[g] = True
    wide, packed = _trees(Triangles.create(np.asarray(jt.verts), np.asarray(jt.faces),
                                           device="cpu"))
    return dict(o=o[keep], d=d[keep], wide=wide, packed=packed)


def _view(make, res: int) -> dict:
    """A scene's primary rays at res^2 and the port's hard trees."""
    from tpurt_torch.render.camera import gen_primary_rays

    sc, cam = make()
    rays = gen_primary_rays(dataclasses.replace(cam, width=res, height=res))
    wide, packed = _trees(sc.tris)
    return dict(o=rays.o.reshape(-1, 3).numpy(), d=rays.d.reshape(-1, 3).numpy(),
                wide=wide, packed=packed)


@pytest.fixture(scope="module")
def views(scene):
    """name -> rays and trees: bunny-3K's special rays, a 32^2 view of a
    20K-triangle sponza (an interior, where many boxes overlap along a
    ray), and cornell at 32^2."""
    from tpurt_torch.core.scene import make_cornell_box, make_sponza_scene

    return {"bunny3k": scene,
            "sponza20k": _view(lambda: make_sponza_scene(num_tris=20_000, device="cpu"), 32),
            "cornell": _view(lambda: make_cornell_box(device="cpu"), 32)}


def _check_hit_frac(name, ids):
    """The rays hit and miss: bunny-3K's between 30% and 95% (its misses
    and special groups), the interior views' above 30%."""
    frac = (ids >= 0).mean()
    assert 0.3 < frac < 0.95 if name == "bunny3k" else 0.3 < frac


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("name", ["bunny3k", "sponza20k"])
def test_closest8_kernel_loop_matches_the_twin(views, name):
    """The closest8 loop returns the twin's (t, u, v, id) and shading lanes
    bit for bit on every ray, walks the twin's visits and rows, and never
    holds more on its stack than the topology's bound."""
    v = views[name]
    got, counts, deepest = _closest8_kernel_loop(v["wide"], v["o"], v["d"])
    stats = {}
    hit, sh = k8.traverse_wide8_ref(_trays(v["o"], v["d"]), v["wide"], shade_out=True,
                                    stats=stats)
    for a, b in zip(got[:4], (hit.t, hit.u, hit.v, hit.tri)):
        assert np.array_equal(_bits(a), _bits(b.numpy()))
    assert np.array_equal(_bits(got[4]), _bits(torch.cat(sh, dim=1).numpy()))
    assert counts == k8.walk_counts(stats)
    _check_hit_frac(name, got[3])
    assert 0 < deepest <= v["wide"].max_stack <= k8.STACKV


@pytest.mark.parametrize("name", ["bunny3k", "sponza20k"])
def test_closest_bin_kernel_loop_matches_the_twin(views, name):
    """The closest_bin loop returns the twin's (t, u, v, id) bit for bit on
    every ray, walks the twin's slab tests and leaves, and its stack never
    holds more than the tree is deep."""
    v = views[name]
    got, counts, deepest = closest_bin_kernel_loop(v["packed"], v["o"], v["d"])
    stats = {}
    hit = kb.traverse_packed_ref(_trays(v["o"], v["d"]), v["packed"], stats=stats)
    for a, b in zip(got, (hit.t, hit.u, hit.v, hit.tri)):
        assert np.array_equal(_bits(a), _bits(b.numpy()))
    assert counts == k8.walk_counts(stats)
    _check_hit_frac(name, got[3])
    assert 0 < deepest <= v["packed"].depth <= BIN_STACK


@pytest.mark.parametrize("name", ["bunny3k", "sponza20k", "cornell"])
def test_near_first_twins_match_the_parent_order(views, name):
    """The selection does not depend on visit order where every hit lies
    inside its boxes: closest_bin's near-first twin returns the parent's
    escape-order twin's outputs on every ray, bit for bit, while walking
    differently."""
    v = views[name]
    rays = _trays(v["o"], v["d"])
    new, old = {}, {}
    a = kb.traverse_packed_ref(rays, v["packed"], stats=new)
    b = closest_walk(rays, kb.PackedLayout(v["packed"]), stats=old)
    for x, y in [(a.t, b.t), (a.u, b.u), (a.v, b.v), (a.tri, b.tri)]:
        assert np.array_equal(_bits(x.numpy()), _bits(y.numpy()))
    assert (a.tri >= 0).any()
    assert k8.walk_counts(new) != k8.walk_counts(old)


def _chain(depth: int) -> tuple[PackedBVH, Rays]:
    """A packed binary tree `depth` levels deep: internal node 2l has leaf
    2l + 1 (an empty triangle) on the left and node 2l + 2 on the right; the
    last node, 2 depth, is a leaf holding one triangle in front of the ray."""
    m = 2 * depth + 1
    node_f32 = torch.zeros((m, 8))
    node_f32[:, 0:3], node_f32[:, 3:6] = -1.0, 1.0
    is_leaf = torch.zeros(m, dtype=torch.int32)
    is_leaf[1::2] = 1
    is_leaf[-1] = 1
    leaf_row = torch.zeros(m, dtype=torch.int32)
    leaf_row[is_leaf > 0] = torch.arange(int(is_leaf.sum()), dtype=torch.int32)
    escape = torch.full((m,), -1, dtype=torch.int32)
    escape[1::2] = torch.arange(2, m, 2, dtype=torch.int32)  # a left leaf's sibling
    node_i32 = torch.stack([escape, leaf_row, torch.zeros_like(escape), is_leaf], dim=1)
    n_leaves = int(is_leaf.sum())
    tri_rows = torch.zeros((n_leaves, 128))
    tri_rows[-1, :9] = torch.tensor([-0.5, -0.5, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0])
    tri_ids = torch.full((n_leaves, LEAF_CAP), -1, dtype=torch.int32)
    tri_ids[-1, 0] = 7
    packed = PackedBVH(node_f32=node_f32, node_i32=node_i32.contiguous(), tri_rows=tri_rows,
                       tri_ids=tri_ids)
    rays = Rays(o=torch.tensor([[0.0, 0.0, -0.9]]), d=torch.tensor([[0.0, 0.0, 1.0]]))
    return packed, rays


@pytest.mark.parametrize("kernel", ["closest_bin", "occluded_bin"])
@pytest.mark.parametrize("depth", [1, 30, BIN_STACK, BIN_STACK + 1, 90])
def test_closest_bin_refuses_a_tree_deeper_than_its_stack(depth, kernel):
    """tree_depth counts the levels of a deep chain; the near-first walks'
    wrappers (closest_bin's and occluded_bin's) walk it up to BIN_STACK
    levels (the escape walk's hit, or flag) and raise beyond, before any
    walk: nothing is dropped silently."""
    packed, rays = _chain(depth)
    assert tree_depth(packed.node_i32) == depth
    if kernel == "closest_bin":
        run, escape = kb.traverse_packed, closest_walk
    else:  # the triangle lies at t = 1.4, inside the window (t_min, 2)
        run = lambda r, p: kb.occluded_packed(r, p, 2.0)  # noqa: E731
        escape = lambda r, lay: occluded_walk(r, lay, 2.0)  # noqa: E731
    if depth > BIN_STACK:
        with pytest.raises(RuntimeError, match="levels deep"):
            run(rays, packed)
        with pytest.raises(RuntimeError, match="levels deep"):
            run(rays, dataclasses.replace(packed, depth=depth))
        return
    got, ref = run(rays, packed), escape(rays, kb.PackedLayout(packed))
    if kernel == "occluded_bin":
        assert got.tolist() == ref.tolist() == [True]
        return
    assert got.tri.tolist() == ref.tri.tolist() == [7]
    assert torch.equal(got.t, ref.t) and float(got.t[0]) == pytest.approx(1.4)


def _two_leaves() -> tuple[PackedBVH, Rays]:
    """A root over two leaves, on the ray's axis: the left one (visited
    first by the escape walk) holds a 1e-3 triangle at z = 5 facing the ray,
    whose |det| = 1e-6 makes tpurt's smooth inverse det / (det^2 + 1e-12)
    halve its t to 2.5; the right one a large triangle at z = 4.7."""
    tri = torch.tensor([[-5e-4, -5e-4, 5.0, 1e-3, 0.0, 0.0, 0.0, 1e-3, 0.0],
                        [-1.0, -1.0, 4.7, 3.0, 0.0, 0.0, 0.0, 3.0, 0.0]])
    lo = torch.stack([tri[:, :3], tri[:, :3] + tri[:, 3:6], tri[:, :3] + tri[:, 6:9]]).amin(0)
    hi = torch.stack([tri[:, :3], tri[:, :3] + tri[:, 3:6], tri[:, :3] + tri[:, 6:9]]).amax(0)
    box = torch.cat([torch.cat([lo.amin(0), hi.amax(0)])[None], torch.cat([lo, hi], dim=1)])
    node_f32 = torch.cat([box, torch.zeros((3, 2))], dim=1)
    node_i32 = torch.tensor([[-1, 0, 0, 0], [2, 0, 0, 1], [-1, 1, 0, 1]], dtype=torch.int32)
    tri_rows = torch.zeros((2, 128))
    tri_rows[:, :9] = tri
    tri_ids = torch.full((2, LEAF_CAP), -1, dtype=torch.int32)
    tri_ids[:, 0] = torch.tensor([11, 22])
    rays = Rays(o=torch.tensor([[-2e-4, -2e-4, 0.0]]), d=torch.tensor([[0.0, 0.0, 1.0]]))
    return PackedBVH(node_f32=node_f32, node_i32=node_i32, tri_rows=tri_rows,
                     tri_ids=tri_ids), rays


def test_smooth_inverse_makes_the_selection_order_dependent():
    """Why closest_bin can return another id than its parent (ROADMAP P6):
    the selection is order-invariant only where every hit's t lies inside
    its boxes along the ray.  tpurt's smooth inverse shrinks t where |det|
    is near 1e-6, so such a hit can lie before its own leaf's box; a walk
    then takes it only if it reaches that leaf before a nearer hit culls
    the box.  The escape walk (left first) takes the tiny triangle's t = 2.5
    from the box at z = 5; the near-first walk enters the nearer box,
    takes t = 4.7 and culls the far box on the pop.  Each kernel returns
    its own walk's id; on the 70K bunny's 512^2 frame 9 of 262,144 rays
    differ so (PERF.md)."""
    packed, rays = _two_leaves()
    escape = closest_walk(rays, kb.PackedLayout(packed))
    near = kb.traverse_packed(rays, packed)
    assert escape.tri.tolist() == [11] and float(escape.t[0]) == pytest.approx(2.5, rel=1e-6)
    assert near.tri.tolist() == [22] and float(near.t[0]) == pytest.approx(4.7, rel=1e-6)
    got, _, _ = closest_bin_kernel_loop(packed, rays.o.numpy(), rays.d.numpy())
    assert got[3].tolist() == [22]
    # the tiny triangle's t lies before its own box (z = 5) along the ray
    assert float(escape.t[0]) < float(packed.node_f32[1, 2])


def _p6_outputs():
    """The two-leaf tree, its ray and each walk's (id, t): the near-first
    walk's (this build's closest_bin) and the escape walk's (the parent's)."""
    packed, rays = _two_leaves()
    near = kb.traverse_packed_ref(rays, packed)
    escape = closest_walk(rays, kb.PackedLayout(packed))
    return packed, rays, (near.tri, near.t), (escape.tri, escape.t)


def test_hit_outside_box_finds_the_shrunk_hit():
    """chip_smoke.hit_outside_box: the tiny triangle's t = 2.5 lies before
    its own box along the ray, the large triangle's t = 4.7 inside its."""
    packed, rays, near, escape = _p6_outputs()
    o, d = rays.o[0], rays.d[0]
    assert chip_smoke.hit_outside_box(packed, o, d, float(escape[1][0]), 11)
    assert not chip_smoke.hit_outside_box(packed, o, d, float(near[1][0]), 22)


@pytest.mark.parametrize("case", ["p6", "swapped_ids", "hit_inside_box", "closest8"])
def test_closest_ab_explains_only_order_dependent_closest_bin_rays(case, monkeypatch):
    """[closest_ab]'s differing_rays lets a ray whose id differs from the
    parent's pass only as P6: closest_bin, each kernel returning its own
    walk's id (near-first for this build, escape for the parent), and the
    better hit outside its triangle's box.  A ray that fails either test,
    and any closest8 ray (its visit order did not change), is unexplained."""
    packed, rays, near, escape = _p6_outputs()
    kernel, new, other, want = "closest_bin", near, escape, 0
    if case == "swapped_ids":  # a fault shared by both twins would show so
        new, other, want = escape, near, 1
    elif case == "hit_inside_box":
        monkeypatch.setattr(chip_smoke, "hit_outside_box", lambda *a: False)
        want = 1
    elif case == "closest8":
        kernel, want = "closest8", 1
    assert chip_smoke.differing_rays("cell", kernel, packed, "parent", rays, new, other) == want


def test_pack_bvh_records_the_depth(scene):
    packed = scene["packed"]
    assert packed.depth == tree_depth(packed.node_i32) > 0


# ---------------------------------------------------------------------------
# P5: every launch on its tensors' card
# ---------------------------------------------------------------------------
KERNELS = pathlib.Path(kb.__file__).resolve().parent


ENTRY_POINTS = {"traverse8.py": {"tpurt_closest8", "tpurt_occluded8", "tpurt_knear8"},
                "traverse.py": {"tpurt_closest_bin", "tpurt_occluded_bin", "tpurt_knear_bin"},
                "treebuild.py": {"tpurt_morton", "tpurt_radix"},
                "softocc.py": {"tpurt_softocc_fwd", "tpurt_softocc_bwd"}}


@pytest.mark.parametrize("module", ["traverse8.py", "traverse.py", "treebuild.py", "softocc.py"])
def test_every_kernel_launch_is_made_on_its_tensors_card(module):
    """Every wrapper of the module launches its entry point, and inside
    _build.on_device."""
    path = KERNELS / module
    launches = {n.attr for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.Attribute) and n.attr.startswith("tpurt_")
                and n.attr != "tpurt_error_string"}
    assert launches == ENTRY_POINTS[module]
    assert _launches_outside_on_device(path) == []


def test_on_device_makes_the_tensors_card_current():
    with pytest.raises(ValueError, match="CUDA tensor"):
        _build.on_device(torch.zeros(3))

    class OnCard1:
        device = torch.device("cuda", 1)

    ctx = _build.on_device(OnCard1())
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 1
