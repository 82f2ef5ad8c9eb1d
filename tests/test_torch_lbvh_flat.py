"""tpurt_torch's threaded flat tree against tpurt's, bit for bit: the treelet
cut, the DFS numbering (dfs), the escape links and every flat_* array of
build_lbvh, on cornell, bunny-3K, sponza-20K and a scene of duplicate Morton
codes, at leaf sizes 1, 4 and 8 (and the soft path's band-inflated boxes),
plus the single-triangle scene."""

import numpy as np
import pytest
import torch

from tests.test_torch_build import _assert_bitwise, _scene_pair
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.core.geometry import Triangles as JTriangles

from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.core.geometry import Triangles

FLAT_FIELDS = ("flat_lo", "flat_hi", "flat_escape", "flat_is_leaf", "flat_first",
               "flat_count", "dfs")
SCENES = ("cornell", "bunny3k", "sponza20k", "dup_codes")


@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    return _scene_pair(request.param)


@pytest.mark.parametrize("leaf_size,band", [(1, 0.0), (4, 0.0), (8, 0.0), (8, 0.08)])
def test_flat_arrays_bitwise(pair, leaf_size, band):
    jt, tt = pair
    jb = j_build_lbvh(jt, leaf_size=leaf_size, band=band)
    tb = build_lbvh(tt, leaf_size=leaf_size, band=band)
    for field in FLAT_FIELDS:
        _assert_bitwise(field, getattr(jb, field), getattr(tb, field))
    assert tb.leaf_size == leaf_size and tb.num_flat == 2 * tt.num_tris - 1


def test_single_triangle_scene():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.array([[0, 1, 2]], np.int32)
    jb = j_build_lbvh(JTriangles.create(v, f), band=0.1)
    tb = build_lbvh(Triangles.create(v, f, device="cpu"), band=0.1)
    for field in FLAT_FIELDS + ("node_lo", "node_hi", "tri_order", "parent"):
        _assert_bitwise(field, getattr(jb, field), getattr(tb, field))
    assert tb.left.numel() == 0 and bool(tb.flat_is_leaf.all())


def test_escape_chain_is_a_preorder(pair):
    """Structure the walks rely on: entering every node visits the live
    nodes 0, 1, ..., in order (escape targets are later nodes), every leaf
    range appears once, and together the leaves cover each sorted triangle
    exactly once."""
    _, tt = pair
    tb = build_lbvh(tt, leaf_size=4)
    esc = tb.flat_escape.numpy()
    n_live = int((tb.dfs < tb.num_flat).sum())
    live = np.arange(n_live)
    assert (esc[live] == -1).sum() >= 1 and ((esc[live] > live) | (esc[live] == -1)).all()
    leaves = live[tb.flat_is_leaf.numpy()[:n_live]]
    cover = np.zeros(tt.num_tris, np.int64)
    for i in leaves:
        first, count = int(tb.flat_first[i]), int(tb.flat_count[i])
        assert 1 <= count <= 4
        cover[first:first + count] += 1
    assert (cover == 1).all()
    assert not tb.flat_is_leaf[n_live:].any() and (esc[n_live:] == -1).all()
    assert torch.equal(tb.flat_count[n_live:], torch.zeros_like(tb.flat_count[n_live:]))
