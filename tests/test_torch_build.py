"""tpurt_torch's build against tpurt's, bit for bit: Morton codes, every
LBVH field the wide path reads, every WideBVH array and its max_stack /
max_rows, for the default fat-leaf size and for fat_tris=8 (the 1M-triangle
scene's size)."""

import numpy as np
import pytest
import torch

from tpurt.accel.bvh8 import build_wide as j_build_wide
from tpurt.accel.bvh8 import collapse8 as j_collapse8
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.accel.morton import triangle_morton_codes as j_morton
from tpurt.core import scene as jscene
from tpurt.core.geometry import Triangles as JTriangles

from tpurt_torch.accel import bvh8
from tpurt_torch.accel.bvh8 import build_wide, decode_lane_i32, encode_lane_i32
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.morton import expand_bits, triangle_morton_codes
from tpurt_torch.core import scene as tscene
from tpurt_torch.core.convert import bvh_from_numpy
from tpurt_torch.core.geometry import Triangles

BVH_FIELDS = ("left", "right", "parent", "first", "last", "node_lo", "node_hi",
              "codes", "tri_order")
WIDE_FIELDS = ("wrow", "tri_rows", "entry_node", "entry_meta", "own_node",
               "escape", "has_int", "row_tids")


def _dup_code_tris():
    """Random triangles, each repeated three times (and some mirrored about
    their centroid): many equal Morton codes, so the sort's tie order
    decides tri_order."""
    rng = np.random.default_rng(11)
    base = rng.uniform(-1, 1, (60, 3, 3)).astype(np.float32)
    c = base.mean(axis=1, keepdims=True)
    mirrored = (2 * c - base).astype(np.float32)
    tris = np.concatenate([base, base, mirrored, base]).reshape(-1, 3)
    faces = np.arange(tris.shape[0]).reshape(-1, 3)
    return tris, faces


def _scene_pair(name):
    if name == "dup_codes":
        v, f = _dup_code_tris()
        return JTriangles.create(v, f), Triangles.create(v, f, device="cpu")
    fn, kw = {"cornell": ("make_cornell_box", {}),
              "bunny3k": ("make_bunny_scene", {"num_tris": 3000}),
              "sponza20k": ("make_sponza_scene", {"num_tris": 20_000})}[name]
    return getattr(jscene, fn)(**kw)[0].tris, getattr(tscene, fn)(**kw, device="cpu")[0].tris


@pytest.fixture(scope="module", params=["cornell", "bunny3k", "sponza20k", "dup_codes"])
def built(request):
    jt, tt = _scene_pair(request.param)
    return request.param, jt, tt, j_build_lbvh(jt), build_lbvh(tt)


def _assert_bitwise(name, a, b):
    a, b = np.asarray(a), b.cpu().numpy()
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == np.float32:
        assert b.dtype == np.float32, name
        a, b = a.view(np.int32), b.view(np.int32)
    elif name == "codes":  # tpurt uint32, the port int64 holding the value
        a = a.astype(np.int64)
    else:
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
    assert np.array_equal(a, b), f"{name}: {(a != b).sum()} entries differ"


def test_morton_codes_bitwise(built):
    _, jt, tt, _, _ = built
    _assert_bitwise("codes", j_morton(jt), triangle_morton_codes(tt))


def test_dup_scene_has_duplicate_codes(built):
    name, _, tt, _, tb = built
    if name == "dup_codes":
        assert torch.unique(tb.codes).numel() < tb.codes.numel() // 2


@pytest.mark.parametrize("field", BVH_FIELDS)
def test_lbvh_field_bitwise(built, field):
    _, _, _, jb, tb = built
    _assert_bitwise(field, getattr(jb, field), getattr(tb, field))


@pytest.mark.parametrize("fat", [None, 8])
def test_wide_bitwise(built, fat):
    _, jt, tt, jb, tb = built
    jw, tw = j_build_wide(jt, jb, fat_tris=fat), build_wide(tt, tb, fat_tris=fat)
    for field in WIDE_FIELDS:
        _assert_bitwise(field, getattr(jw, field), getattr(tw, field))
    assert (jw.max_stack, jw.max_rows) == (tw.max_stack, tw.max_rows)
    assert jw.band == tw.band


def test_port_build_wide_from_tpurt_lbvh(built):
    """tpurt's LBVH handed over through bvh_from_numpy: the port's collapse
    and pack alone reproduce tpurt's WideBVH (separates them from the LBVH
    build)."""
    _, jt, tt, jb, _ = built
    tb = bvh_from_numpy(**{f: np.asarray(getattr(jb, f)) for f in BVH_FIELDS},
                        band=jb.band, device="cpu")
    jw, tw = j_build_wide(jt, jb, fat_tris=8), build_wide(tt, tb, fat_tris=8)
    for field in WIDE_FIELDS:
        _assert_bitwise(field, getattr(jw, field), getattr(tw, field))


def test_collapse8_matches_serial_and_reference():
    """The copied vectorized collapse equals the copied serial oracle and
    tpurt's collapse on a real topology."""
    _, tt = _scene_pair("bunny3k")
    tb = build_lbvh(tt)
    args = [x.numpy() for x in (tb.left, tb.right, tb.first, tb.last)]
    prio = bvh8.node_area_priority(tb)
    got = bvh8.collapse8(*args, 8, prio)
    for ref in (bvh8._collapse8_serial(*args, 8, prio), j_collapse8(*args, 8, prio)):
        for a, b in zip(got, ref):
            assert np.array_equal(a, b)


def test_lane_codec_round_trip():
    v = torch.tensor([bvh8.LANE_MIN, -5, -1, 0, 1, 7, 1 << 24, bvh8.LANE_MAX],
                     dtype=torch.int32)
    e = encode_lane_i32(v)
    assert e.dtype == torch.float32 and bool((e < 0).all())
    assert torch.equal(decode_lane_i32(e.view(torch.int32)), v)
    # an all-zero pad lane decodes to an invalid (negative) id
    assert int(decode_lane_i32(torch.zeros(1, dtype=torch.int32))) == -bvh8.LANE_OFF


def test_expand_bits_matches_uint32_wraparound():
    x = np.arange(1024, dtype=np.uint32)
    ref = np.zeros_like(x)
    for i in range(10):
        ref |= ((x >> i) & 1) << (3 * i)
    assert np.array_equal(expand_bits(torch.from_numpy(x.astype(np.int64))).numpy(),
                          ref.astype(np.int64))
