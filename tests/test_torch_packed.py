"""tpurt_torch's packed binary-BVH layout and its refits against tpurt's, bit
for bit: pack_bvh with make_tracer's static bound max_cut_leaves (and with
the live leaf count), refit_aabbs with and without the flat rewrite, and
refit_packed after a seeded vertex jitter, on cornell, bunny-3K, sponza-20K
and the duplicate-code scene, band 0 and the soft path's 0.08."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_build import _assert_bitwise, _scene_pair
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.accel.packet import max_cut_leaves as j_max_cut_leaves
from tpurt.accel.packet import pack_bvh as j_pack_bvh
from tpurt.accel.packet import refit_packed as j_refit_packed
from tpurt.accel.refit import refit_aabbs as j_refit_aabbs

from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import LEAF_CAP, max_cut_leaves, pack_bvh, refit_packed
from tpurt_torch.accel.refit import refit_aabbs
from tpurt_torch.core.geometry import Triangles
from tpurt_torch.render.pipeline import make_tracer
from tpurt_torch.core.scene import make_cornell_box

PACKED_FIELDS = ("node_f32", "node_i32", "tri_rows", "tri_ids")
BOX_FIELDS = ("node_lo", "node_hi", "flat_lo", "flat_hi")


@pytest.fixture(scope="module", params=["cornell", "bunny3k", "sponza20k", "dup_codes"])
def built(request):
    """Both packages' band-0 and band-0.08 trees of one scene."""
    jt, tt = _scene_pair(request.param)
    trees = {band: (j_build_lbvh(jt, band=band), build_lbvh(tt, band=band))
             for band in (0.0, 0.08)}
    return jt, tt, trees


@pytest.mark.parametrize("band", [0.0, 0.08])
@pytest.mark.parametrize("bound", [True, False])
def test_pack_bitwise(built, band, bound):
    jt, tt, trees = built
    jb, tb = trees[band]
    n_leaves = max_cut_leaves(tt.num_tris, 8) if bound else None
    assert n_leaves == (j_max_cut_leaves(tt.num_tris, 8) if bound else None)
    jp, tp = j_pack_bvh(jt, jb, n_leaves=n_leaves), pack_bvh(tt, tb, n_leaves=n_leaves)
    for field in PACKED_FIELDS:
        _assert_bitwise(field, getattr(jp, field), getattr(tp, field))
    assert tp.band == band
    live = int(tb.flat_is_leaf.sum())
    if bound:  # rows past the live leaves are unreachable zeros
        assert tp.num_leaves == n_leaves > live
        assert not tp.tri_rows[live:].any() and bool((tp.tri_ids[live:] == -1).all())
        assert tp.num_nodes == 2 * n_leaves - 1
    else:
        assert tp.num_leaves == live and tp.num_nodes == 2 * live - 1


def _jittered(jt, tt, seed=5, scale=0.03):
    v = np.asarray(jt.verts)
    moved = v + np.random.default_rng(seed).normal(scale=scale, size=v.shape).astype(np.float32)
    return (jt.replace(verts=jnp.asarray(moved)),
            dataclasses.replace(tt, verts=torch.from_numpy(moved)))


@pytest.mark.parametrize("band", [0.0, 0.08])
def test_refits_bitwise(built, band):
    jt, tt, trees = built
    jb, tb = trees[band]
    jt2, tt2 = _jittered(jt, tt)
    for update_flat in (True, False):
        jr, tr = (j_refit_aabbs(jb, jt2, update_flat=update_flat),
                  refit_aabbs(tb, tt2, update_flat=update_flat))
        for field in BOX_FIELDS:
            _assert_bitwise(field, getattr(jr, field), getattr(tr, field))
    if not update_flat:  # the flat boxes stay the build's
        assert torch.equal(tr.flat_lo, tb.flat_lo)
    n_leaves = max_cut_leaves(tt.num_tris, 8)
    jr, tr = j_refit_aabbs(jb, jt2), refit_aabbs(tb, tt2)
    jp = j_refit_packed(j_pack_bvh(jt, jb, n_leaves=n_leaves), jr, jt2)
    tp = refit_packed(pack_bvh(tt, tb, n_leaves=n_leaves), tr, tt2)
    for field in PACKED_FIELDS:
        _assert_bitwise(field, getattr(jp, field), getattr(tp, field))


def test_refit_at_the_build_vertices_is_the_build(built):
    _, tt, trees = built
    _, tb = trees[0.08]
    tr = refit_aabbs(tb, tt)
    for field in BOX_FIELDS:
        assert torch.equal(getattr(tr, field), getattr(tb, field)), field
    p = pack_bvh(tt, tb)
    q = refit_packed(p, tr, tt)
    assert all(torch.equal(getattr(p, f), getattr(q, f)) for f in PACKED_FIELDS)


@pytest.mark.parametrize("leaf_size,n_tris", [(8, 1), (1, 3)])
def test_bound_past_the_flat_rows_is_guarded(leaf_size, n_tris):
    """On a tiny scene the bound can ask for more than the 2N - 1 flat rows
    (tpurt's pack raises there); the port packs the rows it has."""
    rng = np.random.default_rng(2)
    v = rng.uniform(-1, 1, (3 * n_tris, 3)).astype(np.float32)
    tt = Triangles.create(v, np.arange(3 * n_tris).reshape(-1, 3), device="cpu")
    tb = build_lbvh(tt, leaf_size=leaf_size)
    n_leaves = max_cut_leaves(n_tris, leaf_size)
    assert 2 * n_leaves - 1 > 2 * n_tris - 1
    p = pack_bvh(tt, tb, n_leaves=n_leaves)
    live = pack_bvh(tt, tb)
    assert p.num_nodes == 2 * n_tris - 1 and p.num_leaves == n_leaves
    assert torch.equal(p.node_f32, live.node_f32) and torch.equal(p.node_i32, live.node_i32)
    assert torch.equal(p.tri_rows[:live.num_leaves], live.tri_rows)


def test_make_tracer_packs_with_the_bound_and_checks_leaf_size():
    scene, _ = make_cornell_box(device="cpu")
    tr = make_tracer(scene, "binary", leaf_size=4)
    assert tr.packed.num_leaves == max_cut_leaves(scene.num_tris, 4)
    assert tr.bvh.leaf_size == 4 and tr.wide is None
    assert make_tracer(scene, "bvh").packed is None
    with pytest.raises(ValueError, match="leaf_size"):
        make_tracer(scene, "binary", leaf_size=LEAF_CAP + 1)
