"""What tpurt has beside its engines, against tpurt: Config and load_config,
the key-value sort (sort_ref), build_wide's split_rule, refit_wide, the
LBVH's level-synchronous refit, the Morton helpers, the all-pairs
Möller–Trumbore contraction, the ONB / reflect / smoothstep / sigmoid
helpers, tile rays, pixel_rng and the benchmark's --sort-bench row.

Inputs come from tpurt's scenes or numpy seeds.  Tolerances, with their
reasons:
- configs, sorts, trees, rows, Morton codes, node boxes: bitwise (integer
  work, or f32 min / max / gathers, which are exact).
- intersect_pairs_mm: hits agree on all but 1e-3 of pairs (tpurt's own
  test: a pair on an accept threshold flips with the rounding of the
  contraction, which XLA and torch sum in other orders); where both hit,
  t, u and v within 1e-5 of the larger of 1 and the value.  Features
  within 1e-6 (XLA contracts a*b - c*d into FMAs on the CPU).
- make_onb, reflect, smoothstep, sigmoid, tile rays: within 1e-6 (FMAs and
  transcendental rounding); tile rays also bitwise the matching rows of
  the port's own primary rays.
"""

import dataclasses
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.accel import bvh8 as jbvh8
from tpurt.accel import intersect as jintersect
from tpurt.accel import lbvh as jlbvh
from tpurt.accel import morton as jmorton
from tpurt.accel import sort_ref as jsort
from tpurt.accel.refit import refit_aabbs as j_refit_aabbs
from tpurt.api import config as jconfig
from tpurt.core import math as jmath
from tpurt.core import scene as jscene
from tpurt.core.geometry import AABB as JAABB
from tpurt.core.geometry import Rays as JRays
from tpurt.kernels.traverse8 import occluded_pallas8, traverse_pallas8
from tpurt.render import camera as jcamera
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays
from tpurt.render.pipeline import tri_table as j_tri_table

from tpurt_torch import bench
from tpurt_torch.accel import bvh8, intersect, morton, sort_ref
from tpurt_torch.accel.lbvh import build_lbvh, range_minmax_sparse, refit_node_aabbs
from tpurt_torch.accel.refit import refit_aabbs
from tpurt_torch.api.config import Config, FitConfig, RenderConfig, load_config
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.api.renderer import Renderer
from tpurt_torch.core import math as tmath
from tpurt_torch.core import scene as tscene
from tpurt_torch.core.convert import camera_from_numpy
from tpurt_torch.core.geometry import AABB, Rays, Triangles
from tpurt_torch.kernels import traverse8 as k8
from tpurt_torch.render import camera as tcamera
from tpurt_torch.render.pipeline import render, tri_table

WIDE_FIELDS = ("wrow", "tri_rows", "entry_node", "entry_meta", "own_node",
               "escape", "has_int", "row_tids")
BVH_FIELDS = ("left", "right", "parent", "first", "last", "node_lo", "node_hi",
              "codes", "tri_order", "flat_lo", "flat_hi", "flat_escape", "flat_is_leaf",
              "flat_first", "flat_count", "dfs")


def _eq(got, ref) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return got.shape == ref.shape and np.array_equal(got.astype(ref.dtype), ref)


# -- Config and load_config ------------------------------------------------
FIELDS = {"render": {"method": "packet", "spp": 4, "soft": True, "band": 0.15,
                     "light_samples": 4, "light_seed": 11},
          "fit": {"steps": 7, "lr": 0.003, "optimizer": "sgd", "seed": 5,
                  "ckpt_path": "ck", "grad_chunks": 2},
          "dist": {"coordinator": "localhost:1234", "num_processes": 2, "process_id": 1}}


def test_config_serialisation_matches_tpurt():
    got, ref = Config.from_dict(FIELDS), jconfig.Config.from_dict(FIELDS)
    assert got.to_dict() == ref.to_dict()
    assert got.to_json() == ref.to_json()
    assert got.digest() == ref.digest()
    # the defaults differ in render.method alone
    assert Config().with_overrides({"render.method": "bvh"}).digest() == jconfig.Config().digest()
    assert Config().render.method == "wide8" and FitConfig().seed == 0


def test_load_config_reads_tpurt_json(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(jconfig.Config.from_dict(FIELDS).to_json())
    over = {"fit.lr": "0.5", "render.k_layers": "6", "render.soft": "False",
            "fit.ckpt_path": None}
    got = load_config(str(path), over)
    ref = jconfig.load_config(str(path), over)
    assert got.to_dict() == ref.to_dict()
    assert got.fit.lr == 0.5 and got.render.k_layers == 6
    assert got.render.soft is True  # tpurt's coercion: bool("False")
    assert load_config().to_dict() == Config().to_dict()
    assert Config.from_dict(json.loads(got.to_json())) == got


@pytest.mark.parametrize("call,arg", [
    ("with_overrides", {"render": 1}),
    ("with_overrides", {"render.nope": 1}),
    ("with_overrides", {"mesh.x": 1}),
    ("from_dict", {"fit": {"nope": 1, "alsonot": 2}}),
])
def test_unknown_config_keys_raise_tpurt_keyerror(call, arg):
    def message(cls):
        with pytest.raises(KeyError) as e:
            getattr(cls() if call == "with_overrides" else cls, call)(arg)
        return str(e.value)

    assert message(Config) == message(jconfig.Config)


def test_load_config_yaml_and_its_absence(tmp_path, monkeypatch):
    path = tmp_path / "cfg.yaml"
    path.write_text("render:\n  spp: 2\nfit:\n  steps: 3\n")
    assert load_config(str(path)).to_dict() == dataclasses.replace(
        Config(), render=RenderConfig(spp=2), fit=FitConfig(steps=3)).to_dict()
    got, ref = load_config(str(path)).to_dict(), jconfig.load_config(str(path)).to_dict()
    assert got["fit"] == ref["fit"] and got["render"]["spp"] == ref["render"]["spp"] == 2
    monkeypatch.setitem(sys.modules, "yaml", None)
    for fn in (load_config, jconfig.load_config):
        with pytest.raises(ValueError, match="not JSON and pyyaml unavailable"):
            fn(str(path))


def test_config_sections_drive_renderer_and_fit(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(jconfig.Config().to_json())  # tpurt's defaults: method "bvh"
    cfg = load_config(str(path), {"render.k_layers": 2, "fit.steps": 1, "fit.lr": 1e-3})
    scene, cam = tscene.make_cornell_box(device="cpu")
    cam = dataclasses.replace(cam, width=12, height=12)
    img = Renderer(scene, cfg.render).render(cam)
    assert torch.equal(img, render(scene, cam, method="bvh"))
    soft = dataclasses.replace(cfg.render, soft=True)
    inv = InverseRenderer(scene, cam, fit=cfg.fit, render=soft)
    res = inv.fit(torch.zeros((12, 12, 3)))
    assert inv.tracer0.method == "bvh" and res.steps_run == 1 and np.isfinite(res.losses[0])


# -- sort_ref ----------------------------------------------------------------
def _keys(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    return {"random": rng.integers(0, 2**32, 3000, dtype=np.uint32),
            "equal": rng.integers(0, 4, 3000).astype(np.uint32) * np.uint32(0x01010101),
            "one": np.array([0xDEADBEEF], np.uint32)}[kind]


@pytest.mark.parametrize("kind", ["random", "equal", "one"])
@pytest.mark.parametrize("backend", ["xla", "ref"])
def test_sort_pairs_matches_tpurt(kind, backend):
    keys = _keys(kind)
    vals = np.random.default_rng(4).permutation(keys.shape[0]).astype(np.int32)
    jk, jv = jsort.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), backend=backend)
    tk, tv = sort_ref.sort_pairs(torch.from_numpy(keys.astype(np.int64)),
                                 torch.from_numpy(vals), backend=backend)
    assert _eq(tk, jk) and _eq(tv, jv) and tv.dtype == torch.int32


def test_radix_sort_ref_default_values_and_negative_keys():
    keys = _keys("equal")
    jk, jv = jsort.radix_sort_ref(jnp.asarray(keys))
    tk, tv = sort_ref.radix_sort_ref(torch.from_numpy(keys.astype(np.int64)))
    assert _eq(tk, jk) and _eq(tv, jv)
    # keys are taken mod 2^32, as tpurt's cast to uint32 takes them
    neg = torch.tensor([-1, 5, -(2**31)])
    assert sort_ref.radix_sort_ref(neg)[0].tolist() == [5, 2**31, 2**32 - 1]


def test_sort_pairs_pallas_raises_tpurt_error():
    k, v = torch.zeros(4, dtype=torch.int64), torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"docs/RETIRED\.md"):
        sort_ref.sort_pairs(k, v, backend="pallas")
    with pytest.raises(ValueError, match="nope"):
        sort_ref.sort_pairs(k, v, backend="nope")


@pytest.mark.parametrize("name", ["sponza2k", "dup_codes"])
def test_build_lbvh_ref_sort_is_the_same_tree(name):
    if name == "sponza2k":
        tris = tscene.make_sponza_scene(num_tris=2000, device="cpu")[0].tris
    else:
        rng = np.random.default_rng(11)
        base = rng.uniform(-1, 1, (60, 3, 3)).astype(np.float32)
        v = np.concatenate([base, base, base]).reshape(-1, 3)
        tris = Triangles.create(v, np.arange(v.shape[0]).reshape(-1, 3), device="cpu")
    a, b = build_lbvh(tris), build_lbvh(tris, sort_backend="ref")
    for f in BVH_FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# -- build_wide(split_rule=) and refit_wide ---------------------------------------
def _tris_pair(name):
    fn, kw = {"bunny3k": ("make_bunny_scene", {"num_tris": 3000}),
              "sponza20k": ("make_sponza_scene", {"num_tris": 20_000})}[name]
    return getattr(jscene, fn)(**kw)[0].tris, getattr(tscene, fn)(**kw, device="cpu")[0].tris


@pytest.fixture(scope="module", params=["bunny3k", "sponza20k"])
def count_trees(request):
    jt, tt = _tris_pair(request.param)
    jb, tb = jlbvh.build_lbvh(jt), build_lbvh(tt)
    return dict(jt=jt, tt=tt, tb=tb, jw=jbvh8.build_wide(jt, jb, split_rule="count"),
                tw=bvh8.build_wide(tt, tb, split_rule="count"), area=bvh8.build_wide(tt, tb))


@pytest.mark.parametrize("field", WIDE_FIELDS)
def test_count_rule_tree_bitwise_tpurt(count_trees, field):
    assert _eq(getattr(count_trees["tw"], field), getattr(count_trees["jw"], field))


def test_count_rule_is_another_tree(count_trees):
    tw, jw, area = count_trees["tw"], count_trees["jw"], count_trees["area"]
    assert (tw.max_stack, tw.max_rows) == (jw.max_stack, jw.max_rows)
    assert not torch.equal(tw.entry_node, area.entry_node)


def test_unknown_split_rule_raises(count_trees):
    with pytest.raises(ValueError, match="sah"):
        bvh8.build_wide(count_trees["tt"], count_trees["tb"], split_rule="sah")
    with pytest.raises(ValueError, match="sah"):
        jbvh8.build_wide(count_trees["jt"], jlbvh.build_lbvh(count_trees["jt"]),
                         split_rule="sah")


def test_count_tree_walks_match_tpurt_kernels():
    """tpurt's interpret-mode closest-hit and any-hit kernels on its count
    tree of bunny-3K against the port's twins on the port's count tree: 16^2
    primary rays and their reversed copies with seeded t_max."""
    jscn, jcam = jscene.make_bunny_scene(num_tris=3000)
    tris = tscene.make_bunny_scene(num_tris=3000, device="cpu")[0].tris
    jw = jbvh8.build_wide(jscn.tris, jlbvh.build_lbvh(jscn.tris), split_rule="count")
    tw = bvh8.build_wide(tris, build_lbvh(tris), split_rule="count")
    r = j_gen_primary_rays(jcam.replace(width=16, height=16))
    o = np.concatenate([np.array(r.o)] * 2)
    d = np.concatenate([np.array(r.d), -np.array(r.d)])
    tmax = np.random.default_rng(2).uniform(0.5, 8, o.shape[0]).astype(np.float32)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    jh = traverse_pallas8(jr, jscn.tris, jw)
    jblk = occluded_pallas8(jr, jscn.tris, jw, jnp.asarray(tmax))
    tr = Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))
    th = k8.traverse_wide8(tr, tw)
    tblk = k8.occluded_wide8(tr, tw, torch.from_numpy(tmax))
    assert _eq(th.tri, jh.tri) and _eq(tblk, np.asarray(jblk).astype(bool))
    assert 0.2 < float((th.tri >= 0).float().mean()) < 0.8 and 0 < int(tblk.sum()) < o.shape[0]


def test_node_areas_matches_tpurt(count_trees):
    tb = count_trees["tb"]
    ref = jbvh8.node_areas(tb.node_lo.numpy(), tb.node_hi.numpy())
    got = bvh8.node_areas(tb.node_lo, tb.node_hi)
    assert got.dtype == np.float64 and np.array_equal(got, ref)


@pytest.fixture(scope="module")
def moved_band_trees():
    """bunny-3K's band-0.08 trees in both packages, and its vertices moved by
    seeded noise."""
    jscn = jscene.make_bunny_scene(num_tris=3000)[0]
    tscn = tscene.make_bunny_scene(num_tris=3000, device="cpu")[0]
    jb, tb = jlbvh.build_lbvh(jscn.tris, band=0.08), build_lbvh(tscn.tris, band=0.08)
    v = np.array(jscn.tris.verts)
    moved = v + np.random.default_rng(6).normal(scale=0.01, size=v.shape).astype(np.float32)
    jt = jscn.tris.replace(verts=jnp.asarray(moved))
    tt = dataclasses.replace(tscn.tris, verts=torch.from_numpy(moved))
    return dict(jt=jt, tt=tt, jb=jb, tb=tb, jw=jbvh8.build_wide(jscn.tris, jb),
                tw=bvh8.build_wide(tscn.tris, tb))


@pytest.mark.parametrize("with_table", [False, True])
def test_refit_wide_matches_tpurt_and_direct(moved_band_trees, with_table):
    m = moved_band_trees
    jt, tt = m["jt"], m["tt"]
    jtab = j_tri_table(jt) if with_table else None
    ttab = tri_table(tt) if with_table else None
    ref = jbvh8.refit_wide(m["jw"], j_refit_aabbs(m["jb"], jt), jt, jtab)
    got = bvh8.refit_wide(m["tw"], refit_aabbs(m["tb"], tt), tt, ttab)
    assert _eq(got.wrow, ref.wrow) and _eq(got.tri_rows, ref.tri_rows)
    # refit_wide_direct folds the same boxes without the binary tree
    direct = bvh8.refit_wide_direct(m["tw"], tt)
    assert torch.equal(got.wrow, direct.wrow) and torch.equal(got.tri_rows, direct.tri_rows)
    assert not torch.equal(got.wrow, m["tw"].wrow)  # the boxes moved
    for f in WIDE_FIELDS[2:]:
        assert torch.equal(getattr(got, f), getattr(m["tw"], f)), f


@pytest.mark.parametrize("n,seed", [(2, 0), (7, 1), (100, 2), (1000, 3)])
def test_refit_node_aabbs_matches_tpurt_and_rmq(n, seed):
    """tpurt's test_range_minmax_sparse_matches_levelsync scenes."""
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(3 * n, 3)).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    tris = Triangles.create(verts, faces, device="cpu")
    bvh = build_lbvh(tris)
    v0, v1, v2 = tris.corners()
    order = bvh.tri_order.long()
    tlo = torch.minimum(torch.minimum(v0, v1), v2)[order]
    thi = torch.maximum(torch.maximum(v0, v1), v2)[order]
    lo, hi = refit_node_aabbs(bvh.left, bvh.right, tlo, thi, 128)
    jlo, jhi = jlbvh.refit_node_aabbs(jnp.asarray(bvh.left.numpy()),
                                      jnp.asarray(bvh.right.numpy()),
                                      jnp.asarray(tlo.numpy()), jnp.asarray(thi.numpy()), 128)
    assert _eq(lo, jlo) and _eq(hi, jhi)
    rlo, rhi = range_minmax_sparse(tlo, thi, bvh.first, bvh.last)
    assert torch.equal(lo, rlo) and torch.equal(hi, rhi)


# -- Morton helpers ----------------------------------------------------------
def test_expand_bits_and_naive_match_tpurt():
    x = np.concatenate([np.arange(1024), np.random.default_rng(0).integers(
        0, 2**32, 4096)]).astype(np.uint32)
    ref = np.asarray(jmorton.expand_bits(jnp.asarray(x)))
    for fn in (morton.expand_bits, morton.expand_bits_naive):
        got = fn(torch.from_numpy(x.astype(np.int64)))
        assert _eq(got, ref if fn is morton.expand_bits else
                   np.asarray(jmorton.expand_bits_naive(jnp.asarray(x)))), fn.__name__
    assert _eq(morton.expand_bits_naive(torch.arange(1024)), ref[:1024])


def test_quantize_and_morton3d_match_tpurt():
    rng = np.random.default_rng(1)
    p = rng.uniform(-3, 5, (4, 500, 3)).astype(np.float32)
    lo, hi = p.reshape(-1, 3).min(0), p.reshape(-1, 3).max(0)
    p[0, :3] = lo  # the box's corners and a point past it (clamped)
    p[0, 3:6] = hi
    p[0, 6] = hi + 1.0
    jb = JAABB(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    tp, tlo, thi = (torch.from_numpy(x) for x in (p, lo, hi))
    assert _eq(morton.quantize(tp, tlo, thi), jmorton.quantize(jnp.asarray(p), jb.lo, jb.hi))
    codes = morton.morton3d(tp, AABB(lo=tlo, hi=thi))
    assert codes.shape == (4, 500) and _eq(codes, jmorton.morton3d(jnp.asarray(p), jb))


# -- all-pairs Möller–Trumbore as one contraction ----------------------------
@pytest.fixture(scope="module")
def pairs():
    """tpurt's test_mm_formulation_matches_scalar sizes, from a numpy seed."""
    rng = np.random.default_rng(0)
    V = (rng.normal(size=(64, 3, 3)) * 2.0).astype(np.float32)
    o = (rng.normal(size=(128, 3)) * 3.0).astype(np.float32)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    return o, d, V[:, 0], V[:, 1], V[:, 2]


def test_ray_and_tri_features_match_tpurt(pairs):
    o, d, v0, v1, v2 = pairs
    np.testing.assert_allclose(
        intersect.ray_features(torch.from_numpy(o), torch.from_numpy(d)).numpy(),
        np.asarray(jintersect.ray_features(jnp.asarray(o), jnp.asarray(d))),
        rtol=0, atol=1e-6 * 20)
    got = intersect.tri_features(*(torch.from_numpy(x) for x in (v0, v1, v2))).numpy()
    ref = np.asarray(jintersect.tri_features(*(jnp.asarray(x) for x in (v0, v1, v2))))
    assert got.shape == (64, 10, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_intersect_pairs_mm_matches_tpurt_and_scalar(pairs):
    o, d, v0, v1, v2 = pairs
    got = intersect.intersect_pairs_mm(*(torch.from_numpy(x) for x in pairs))
    ref = jintersect.intersect_pairs_mm(*(jnp.asarray(x) for x in pairs))
    hit, jhit = got[3].numpy(), np.asarray(ref[3])
    assert hit.shape == (128, 64) and hit.sum() > 50
    assert np.mean(hit == jhit) > 0.999
    both = hit & jhit
    for g, r in zip(got[:3], ref[:3]):
        g, r = g.numpy()[both], np.asarray(r)[both]
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.maximum(1.0, np.abs(r)).max())
    # and the scalar test on the same pairs (tpurt's own bound)
    t_s, _, _, hit_s = intersect.intersect_tri(
        torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None],
        *(torch.from_numpy(x)[None] for x in (v0, v1, v2)))
    assert np.mean(hit == hit_s.numpy()) > 0.999
    ok = hit & hit_s.numpy()
    np.testing.assert_allclose(got[0].numpy()[ok], t_s.numpy()[ok], rtol=2e-3, atol=2e-4)


# -- core/math helpers, tile rays, pixel_rng -------------------------------------
def test_onb_reflect_smoothstep_sigmoid_match_tpurt():
    rng = np.random.default_rng(5)
    n = rng.normal(size=(300, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:3] = [[0, 0, 1], [0, 0, -1], [1, 0, 0]]
    d = rng.normal(size=(300, 3)).astype(np.float32)
    x = rng.uniform(-2, 3, 300).astype(np.float32)
    tn, td, tx = (torch.from_numpy(a) for a in (n, d, x))
    for g, r in zip(tmath.make_onb(tn), jmath.make_onb(jnp.asarray(n))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    t, b, _ = tmath.make_onb(tn)
    basis = torch.stack([t, b, tn], dim=1)
    assert torch.allclose(basis @ basis.transpose(1, 2), torch.eye(3).expand(300, 3, 3),
                          atol=1e-5)
    pairs = ((tmath.reflect(td, tn), jmath.reflect(jnp.asarray(d), jnp.asarray(n))),
             (tmath.smoothstep(-0.5, 1.5, tx), jmath.smoothstep(-0.5, 1.5, jnp.asarray(x))),
             (tmath.sigmoid(tx), jmath.sigmoid(jnp.asarray(x))))
    for g, r in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


@pytest.mark.parametrize("tile", [(0, 0, 8, 8), (5, 17, 7, 11), (40, 60, 8, 4)])
def test_gen_tile_rays_matches_tpurt_and_primary_rays(tile):
    jcam = jscene.make_cornell_box()[1].replace(width=64, height=48)
    a = lambda x: np.asarray(x)  # noqa: E731
    cam = camera_from_numpy(eye=a(jcam.eye), target=a(jcam.target), up=a(jcam.up),
                            fov_y_deg=a(jcam.fov_y_deg), width=64, height=48, device="cpu")
    y0, x0, th, tw = tile
    got = tcamera.gen_tile_rays(cam, y0, x0, th, tw)
    ref = jcamera.gen_tile_rays(jcam, y0, x0, th, tw)
    assert got.o.shape == (th * tw, 3)
    np.testing.assert_allclose(got.d.numpy(), np.asarray(ref.d), rtol=0, atol=1e-6)
    assert _eq(got.o, ref.o)
    full = tcamera.gen_primary_rays(cam)
    rows = ((y0 + torch.arange(th))[:, None] * 64 + x0 + torch.arange(tw)[None]).reshape(-1)
    assert torch.equal(got.d, full.d[rows]) and torch.equal(got.o, full.o[rows])


def test_pixel_rng_deterministic_order_free_distinct():
    idx = torch.arange(1 << 16)
    a = tmath.pixel_rng(7, idx)
    perm = torch.randperm(idx.shape[0], generator=torch.Generator().manual_seed(0))
    assert a.dtype == torch.int64 and torch.equal(a, tmath.pixel_rng(7, idx))
    assert torch.equal(tmath.pixel_rng(7, idx[perm]), a[perm])
    assert torch.equal(tmath.pixel_rng(7, idx.reshape(256, 256)), a.reshape(256, 256))
    assert a.unique().numel() == a.numel() and bool(((a >= 0) & (a < 2**32)).all())
    assert not torch.equal(tmath.pixel_rng(8, idx), a)
    assert (tmath.pixel_rng(2**40 + 7, idx) != a).float().mean() > 0.99
    # each pixel's seed starts its own stream
    g = [torch.rand(2, generator=torch.Generator().manual_seed(int(s))) for s in a[:2]]
    assert not torch.equal(g[0], g[1])


# -- bench --sort-bench --------------------------------------------------------
def test_sort_bench_row_on_the_cpu(capsys):
    assert bench.main(["--device", "cpu", "--scene", "sponza", "--tris", "2000", "--width", "8",
                       "--height", "8", "--skip-5m", "--iters", "1", "--warmup", "0",
                       "--sort-bench"]) == 0
    err = capsys.readouterr().err.splitlines()
    rows = [json.loads(ln) for ln in err if ln.startswith("{") and "sort_bench" in ln]
    assert len(rows) == 1
    row = rows[0]
    assert {"sort_bench", "keys", "ms", "mkeys_per_s", "compile_s"} <= set(row)
    assert row["sort_bench"] == "xla" and row["keys"] == 1 << 14 and row["sorted"] is True
    assert row["ms"] > 0 and row["mkeys_per_s"] > 0

