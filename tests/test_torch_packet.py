"""tpurt_torch's packet engine (kernels/packet.py) and wavefront engine
(accel/wavefront.py) against tpurt's (accel/packet.py, accel/wavefront.py).

The port's packet twins (what its wrappers run on CPU tensors) take the
port's packed tree and are compared with tpurt's traverse_packet,
occluded_packet and k_nearest_ids_packet run on the CPU as tpurt's own
tests/oracle/test_packet_oracle.py runs them, over the same tree: the
port's eager build, handed to tpurt as its own BVH and PackedBVH (tpurt's
eager build_lbvh and pack_bvh give the same arrays bit for bit, as
tests/test_torch_lbvh_flat.py and tests/test_torch_packed.py hold; its
jitted build rounds band boxes otherwise, ROADMAP P4).
The inputs: cornell at 64^2 (4 packets), bunny-3K at 48^2 (2,304 rays: 3
packets, the last padded with 768 zero rays) and bunny-3K's 64^2 rays with
tests/test_torch_traverse8.py's special groups, in tpurt's grouping (packet
p is rays [1024 p, 1024 p + 1024)), each with a seeded per-ray t_max.

Tolerances, with their reasons:
- hit ids and blocked flags: bitwise.  The packet walk's results are its
  own (a ray can be hit through its packet: P1, P3), and the port
  reproduces them, those rays included.  XLA's CPU backend contracts a*b+c
  into FMAs inside tpurt's jitted loops (P2; the port does not), which
  flips exact t-ties between cornell's coplanar triangles: tpurt's result
  there is recomputed op by op (jax.disable_jit) on the packets (rays, for
  the wave) where it differs, and must then be equal.
- k-lists: bitwise, except P2 rays, held to tests/test_torch_traverse_bin.py's
  rule (every differing candidate a t-tie within 1e-4 or at a band edge),
  at most 2e-3 of the rays.
- t, u, v: bitwise equal to tpurt's own Möller–Trumbore on the winning
  triangle, evaluated op by op; the jitted engine's values differ from it
  by P2's FMAs (up to 1.03e-4 on a grazing bunny hit).
- images: tests/golden/test_golden.py's _check at tpurt's own thresholds
  (frac 0.0 for bunny3k_packet_48.npy, a packet render; 0.003 for cornell
  through an engine).
- the 2-step SGD fit: tests/test_torch_fit.py's (losses rtol 1e-4,
  parameters atol 1e-5), with tpurt's gather_verts bound to a plain gather
  (ROADMAP F1).

Every twin runs with one intra-op thread: its lockstep steps are small
tensor ops, which other test processes' threads slow down many times over.
"""

import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.diff.gather_grad as j_gather_grad
import tpurt.render.pipeline as j_pipeline
from tests.golden.test_golden import _check
from tests.launch_scan import launches_outside_on_device
from tests.test_torch_traverse8 import _bunny_rays, _trays
from tests.test_torch_traverse_bin import _explain
from tpurt.accel import packet as jp
from tpurt.accel import wavefront as jw
from tpurt.accel.lbvh import BVH as JBVH
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.api.config import FitConfig as JFitConfig
from tpurt.api.config import RenderConfig as JRenderConfig
from tpurt.api.inverse import InverseRenderer as JInverseRenderer
from tpurt.core import scene as jscene
from tpurt.core.geometry import Rays as JRays
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays

from tpurt_torch.accel import wavefront as tw
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.accel.traverse_ref import mt9, occluder_ids_ref
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer
from tpurt_torch.core.convert import camera_from_numpy, scene_from_numpy
from tpurt_torch.core.geometry import T_MAX, Rays, Triangles
from tpurt_torch.core.scene import make_bunny_scene
from tpurt_torch.dist import ring as ring_mod
from tpurt_torch.kernels import packet as kp
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.render.pipeline import render

BAND = 0.08
MAX_TIE_FRAC = 2e-3
CASES = ("cornell64", "bunny48", "groups")
KS = (4, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_tris(jt) -> Triangles:
    return Triangles.create(np.asarray(jt.verts), np.asarray(jt.faces), device="cpu")


def _inputs(name: str):
    """(tpurt triangles, o, d, per-ray t_max, groups or None)."""
    if name == "groups":
        return _bunny_rays()
    if name == "cornell64":
        sc, cam = jscene.make_cornell_box()
        cam = cam.replace(width=64, height=64)
    else:
        sc, cam = jscene.make_bunny_scene(num_tris=3000)
        cam = cam.replace(width=48, height=48)
    r = j_gen_primary_rays(cam)
    o, d = np.array(r.o).reshape(-1, 3), np.array(r.d).reshape(-1, 3)
    tmax = np.random.default_rng(3).uniform(-1, 8, o.shape[0]).astype(np.float32)
    return sc.tris, o, d, tmax, None


def _trees(tt, band: float):
    """The port's eager LBVH and packed tree, and the same arrays as
    tpurt's BVH and PackedBVH (tpurt's eager build_lbvh and pack_bvh give
    them bit for bit: tests/test_torch_lbvh_flat.py, test_torch_packed.py)."""
    tb = build_lbvh(tt, band=band)
    tpk = pack_bvh(tt, tb, max_cut_leaves(tt.num_tris, 8))
    a = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    jb = JBVH(**{f.name: a(getattr(tb, f.name)) for f in dataclasses.fields(JBVH)
                 if f.name not in ("codes", "leaf_size", "band")},
              codes=jnp.asarray(tb.codes.numpy().astype(np.uint32)),
              leaf_size=tb.leaf_size, band=tb.band)
    jpk = jp.PackedBVH(node_f32=a(tpk.node_f32), node_i32=a(tpk.node_i32),
                       tri_rows=a(tpk.tri_rows), tri_ids=a(tpk.tri_ids), band=tpk.band)
    return jb, tb, jpk, tpk


def _hit(h) -> dict:
    return {"x": np.asarray(h.tri), "t": np.asarray(h.t), "u": np.asarray(h.u),
            "v": np.asarray(h.v)}


def _settle(ref: dict, got: np.ndarray, run, unit: int) -> tuple[dict, int]:
    """tpurt's jitted result ref (ids, flags or lists under "x"), with each
    unit of rays (a packet, or one ray for the wave) where it differs from
    the port's recomputed op by op (jax.disable_jit) by run(slice): jitted,
    XLA's CPU backend contracts FMAs (P2), which flips exact t-ties between
    coplanar triangles that share an edge (cornell's walls).  Returns the
    settled reference and the count of units recomputed."""
    ref = {k: np.array(v) for k, v in ref.items()}
    differ = ref["x"] != got
    differ = differ.any(-1) if differ.ndim > 1 else differ
    units = np.unique(np.nonzero(differ)[0] // unit)
    for p in units:
        sl = slice(p * unit, (p + 1) * unit)
        with jax.disable_jit():
            part = run(sl)
        for k in ref:
            ref[k][sl] = np.asarray(part[k])
    return ref, len(units)


@functools.cache
def _case(name: str) -> dict:
    """Each package's packet and wave engines on the same rays: closest hit
    and any hit (per-ray t_max) on the band-0 tree, k = 4 (t_max = T_MAX)
    and k = 8 (per-ray t_max) on the band-0.08 tree; tpurt's results
    settled (_settle) against the port's."""
    jt, o, d, tmax, groups = _inputs(name)
    tt = _port_tris(jt)
    tr, ttm = _trays(o, d), torch.from_numpy(tmax)
    out = dict(name=name, o=o, d=d, tmax=tmax, groups=groups, tt=tt,
               tpurt={}, port={}, jwave={}, twave={}, redone={})

    def jrays(sl):
        return JRays(o=jnp.asarray(o[sl]), d=jnp.asarray(d[sl]))

    def jtm(sl, k=None):
        return T_MAX if k == 4 else jnp.asarray(tmax[sl])

    def settle(side, key, got, run, unit):
        out[side][key], out["redone"][side, key] = _settle(run(slice(None)), got, run, unit)

    jb, tb, jpk, tpk = _trees(tt, 0.0)
    out.update(packed=tpk, bvh=tb)
    out["port"]["closest"] = _hit(kp.traverse_packet(tr, tpk))
    out["port"]["occluded"] = {"x": kp.occluded_packet(tr, tpk, ttm).numpy()}
    out["twave"]["closest"] = _hit(tw.wave_closest(tr, tt, tb))
    out["twave"]["occluded"] = {"x": tw.wave_occluded(tr, tt, tb, ttm).numpy()}
    settle("tpurt", "closest", out["port"]["closest"]["x"],
           lambda sl: _hit(jp.traverse_packet(jrays(sl), jt, jpk)), kp.PACKET_RAYS)
    settle("tpurt", "occluded", out["port"]["occluded"]["x"],
           lambda sl: {"x": jp.occluded_packet(jrays(sl), jt, jpk, jtm(sl))}, kp.PACKET_RAYS)
    settle("jwave", "closest", out["twave"]["closest"]["x"],
           lambda sl: _hit(jw.wave_closest(jrays(sl), jt, jb)), 1)
    settle("jwave", "occluded", out["twave"]["occluded"]["x"],
           lambda sl: {"x": jw.wave_occluded(jrays(sl), jt, jb, jtm(sl))}, 1)
    jb, tb, jpk, tpk = _trees(tt, BAND)
    out.update(band_packed=tpk)
    jr = jrays(slice(None))
    for k in KS:
        tm = T_MAX if k == 4 else ttm
        out["port"][k] = {"x": kp.k_nearest_ids_packet(tr, tpk, k, BAND, t_max=tm).numpy()}
        out["twave"][k] = {"x": tw.wave_k_ids(tr, tt, tb, k, BAND, t_max=tm).numpy()}
        out["tpurt"][k] = {"x": np.asarray(jp.k_nearest_ids_packet(
            jr, jt, jpk, k, BAND, t_max=jtm(slice(None), k)))}
        out["jwave"][k] = {"x": np.asarray(jw.wave_k_ids(jr, jt, jb, k, BAND,
                                                         t_max=jtm(slice(None), k)))}
    for side in ("tpurt", "port", "jwave", "twave"):
        out[side] = {k: v if k == "closest" else v["x"] for k, v in out[side].items()}
    return out


@pytest.fixture(params=CASES)
def case(request):
    return _case(request.param)


def _assert_hits_match(case, ref: dict, got: dict, mt) -> np.ndarray:
    """Ids bitwise; each hit's t, u, v bitwise equal to tpurt's own
    Möller–Trumbore (mt: accel/packet.py _mt_packet or accel/wavefront.py
    _mt_batch) on the winning triangle, evaluated op by op (the jitted
    engine's last bits move under P2's FMAs: up to 1.03e-4 on a grazing
    bunny hit); a miss is T_MAX, 0, 0."""
    assert np.array_equal(ref["x"], got["x"])
    hit = got["x"] >= 0
    ids = got["x"][hit]
    v0, v1, v2 = (jnp.asarray(c.numpy()[ids]) for c in case["tt"].corners())
    o, d = jnp.asarray(case["o"][hit]), jnp.asarray(case["d"][hit])
    with jax.disable_jit():
        tuv = mt(o, d, v0, v1 - v0, v2 - v0) if mt is jp._mt_packet else mt(o, d, v0, v1, v2)
    for f, want in zip("tuv", tuv):
        want = np.asarray(want).reshape(-1)
        assert np.array_equal(got[f][hit].view(np.int32), want.view(np.int32)), f
    assert (got["t"][~hit] == np.float32(T_MAX)).all()
    assert not got["u"][~hit].any() and not got["v"][~hit].any()
    return hit


def test_p2_ties_are_few(case):
    """Only cornell's coplanar walls put closest hits on exact t-ties that
    XLA's FMAs flip: at most 2 packets or rays a call were recomputed op by
    op, and none on the bunny."""
    assert max(case["redone"].values()) <= 2
    if case["name"] != "cornell64":
        assert not any(case["redone"].values())


def _lists_match(case, ref, got):
    """k-lists bitwise, but for P2 rays: their differing candidates are
    t-ties or at a band edge (tests/test_torch_traverse_bin.py's _explain);
    at most MAX_TIE_FRAC of the rays (measured: 2 of 2,304 bunny48 rays at
    k = 4 and 8; 5 and 2 of the 4,096 groups rays)."""
    bad = _explain(case, ref, got, BAND)
    assert len(bad) <= MAX_TIE_FRAC * got.shape[0], bad


def test_closest_matches_tpurt_packet(case):
    hit = _assert_hits_match(case, case["tpurt"]["closest"], case["port"]["closest"],
                             jp._mt_packet)
    assert 0.05 < hit.mean() < 1.0 or case["name"] == "cornell64"


def test_occluded_matches_tpurt_packet(case):
    got = case["port"]["occluded"]
    assert np.array_equal(case["tpurt"]["occluded"], got)
    assert 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("k", KS)
def test_knear_matches_tpurt_packet(case, k):
    got = case["port"][k]
    _lists_match(case, case["tpurt"][k], got)
    filled = (got >= 0).sum(-1)
    assert (filled > 0).any() and (filled < k).any()


def test_wave_matches_tpurt_wave(case):
    _assert_hits_match(case, case["jwave"]["closest"], case["twave"]["closest"], jw._mt_batch)
    assert np.array_equal(case["jwave"]["occluded"], case["twave"]["occluded"])
    for k in KS:
        _lists_match(case, case["jwave"][k], case["twave"][k])


def test_empty_slots_drop_a_candidate_at_t_max():
    """P9: tpurt's per-ray walks, its wave and its packet engine start their
    k-lists with (T_MAX, -1) slots, so a candidate at t = T_MAX (possible
    only under t_max > T_MAX) sorts after them and is dropped; its Pallas
    kernels, and the port's binary twins and kernels after them, start with
    (T_MAX, big id) and keep it.  The port's wave, its "bvh" engine
    (occluder_ids_ref) and its packet twin drop it as tpurt's do."""
    from tpurt.accel import traverse_ref as jref
    from tpurt.core.geometry import Triangles as JTriangles

    verts = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    jt, tt = JTriangles.create(verts, faces), Triangles.create(verts, faces, device="cpu")
    o = np.array([[0, 0, -np.float32(T_MAX)]], np.float32)  # the hit lies at t = T_MAX
    d = np.array([[0, 0, 1]], np.float32)
    jr, tr = JRays(o=jnp.asarray(o), d=jnp.asarray(d)), _trays(o, d)
    jb, tb, jpk, tpk = _trees(tt, BAND)
    big = 4.0 * T_MAX
    dropped = [[-1] * 4]
    assert np.asarray(jw.wave_k_ids(jr, jt, jb, 4, BAND, t_max=big)).tolist() == dropped
    assert np.asarray(jref.occluder_ids_ref(jr, jt, jb, 4, BAND, 1e-4,
                                            jnp.full(1, big))).tolist() == dropped
    assert np.asarray(jp.k_nearest_ids_packet(jr, jt, jpk, 4, BAND, t_max=big)).tolist() == dropped
    tm = torch.tensor([big])
    assert tw.wave_k_ids(tr, tt, tb, 4, BAND, t_max=big).tolist() == dropped
    assert occluder_ids_ref(tr, tt, tb, 4, BAND, 1e-4, tm).tolist() == dropped
    assert kp.k_nearest_ids_packet(tr, tpk, 4, BAND, t_max=big).tolist() == dropped
    assert kb.k_nearest_ids_packed_ref(tr, tpk, 4, BAND, t_max=big).tolist() == [[0, -1, -1, -1]]


def test_padded_packet_pad_rays_start_inside_the_root_box():
    """bunny48's last packet holds 256 rays and 768 zero rays, whose origin
    lies in the root box: for the closest hit they vote for every box that
    holds the origin; the port reproduces tpurt there too (the tests
    above)."""
    case = _case("bunny48")
    n = case["o"].shape[0]
    assert n == 2304 and n % kp.PACKET_RAYS == 256
    lo, hi = case["packed"].node_f32[0, :3].numpy(), case["packed"].node_f32[0, 3:6].numpy()
    assert ((lo <= 0) & (0 <= hi)).all()


def test_tiny_negative_rays_are_hit_through_their_packet():
    """P1: a ray with a direction component in [-1e-30, 0) fails every slab
    test of its own, so the per-ray walk misses it; the packet walk hits it
    where a neighbour opens the leaf, in the port as in tpurt."""
    case = _case("groups")
    g = case["groups"]["tiny_neg31"]
    got = case["port"]["closest"]["x"][g]
    per_ray = kb.traverse_packed_ref(_trays(case["o"][g], case["d"][g]), case["packed"])
    assert (per_ray.tri.numpy() == -1).all()
    assert (got >= 0).any()
    assert np.array_equal(got, case["tpurt"]["closest"]["x"][g])


def _outside_box(tris: Triangles, o, d, tid: int, t: float) -> bool:
    """Whether the ray's band hit on tid lies outside tid's band-inflated
    box (build_lbvh's formula)."""
    v0, v1, v2 = (c[tid].numpy() for c in tris.corners())
    lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
    pad = np.float32(BAND) * (np.abs(v1 - v0) + np.abs(v2 - v0)) + np.float32(1e-7)
    p = o + np.float32(t) * d
    return bool(((p < lo - pad) | (p > hi + pad)).any())


def test_band_corner_candidates_found_through_the_packet():
    """P3: at k = 4 the packet walk finds a band hit outside its own
    inflated box, which the per-ray walk over the same tree cannot reach;
    the port finds it as tpurt does."""
    case = _case("groups")
    o, d = case["o"], case["d"]
    per_ray = kb.k_nearest_ids_packed_ref(_trays(o, d), case["band_packed"], 4, BAND).numpy()
    got = case["port"][4]
    p1 = set(case["groups"]["tiny_neg31"].tolist())
    found = []
    for i in np.nonzero((per_ray != got).any(-1))[0]:
        if i in p1:
            continue
        extra = set(got[i].tolist()) - set(per_ray[i].tolist()) - {-1}
        for x in extra:
            t, _, _, _ = mt9(torch.from_numpy(o[i:i + 1]), torch.from_numpy(d[i:i + 1]),
                             _tri9(case["tt"], x))
            if _outside_box(case["tt"], o[i], d[i], x, float(t)):
                found.append((int(i), x))
    assert found
    assert all(np.array_equal(got[i], case["tpurt"][4][i]) for i, _ in found)


def _tri9(tris: Triangles, tid: int) -> torch.Tensor:
    """(1, 1, 9): triangle tid's (v0, e1, e2), as mt9 takes it."""
    v0, v1, v2 = (c[tid] for c in tris.corners())
    return torch.cat([v0, v1 - v0, v2 - v0])[None, None]


# ---------------------------------------------------------------------------
# Through the pipeline
# ---------------------------------------------------------------------------
def test_golden_bunny_packet():
    """tpurt's own packet render, held at its own frac 0.0."""
    scene, cam = make_bunny_scene(num_tris=3000, device="cpu")
    img = render(scene, dataclasses.replace(cam, width=48, height=48), method="packet")
    _check(img, "bunny3k_packet_48.npy", frac=0.0)


def _plain(verts, idx, grad_cols=None):
    return verts[idx]


def test_sgd_fit_packet_matches_tpurt_packet(monkeypatch):
    """Two SGD steps of verts and albedo through "packet" (refit_aabbs and
    refit_packed in the step), cornell at 16^2 toward the albedo x 0.8
    image, against tpurt's "packet" fit; F1 bypassed."""
    monkeypatch.setattr(j_gather_grad, "gather_verts", _plain)
    monkeypatch.setattr(j_pipeline, "gather_verts", _plain)
    js, jc = jscene.make_cornell_box()
    jc = jc.replace(width=16, height=16)
    rk = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
    dim = js.replace(tris=js.tris.replace(albedo=js.tris.albedo * 0.8))
    tgt = np.array(j_pipeline.render(dim, jc, method="brute", **rk))
    fit = dict(steps=2, optimizer="sgd", lr=2e-6, grad_chunks=1)
    ref = JInverseRenderer(js, jc, fit=JFitConfig(**fit),
                           render=JRenderConfig(method="packet", **rk)).fit(tgt)
    a = np.asarray
    ts = scene_from_numpy(
        verts=a(js.tris.verts), faces=a(js.tris.faces), albedo=a(js.tris.albedo),
        emission=a(js.tris.emission), light_pos=a(js.lights.pos),
        light_intensity=a(js.lights.intensity), background=a(js.background),
        ambient=a(js.ambient), device="cpu")
    tc = camera_from_numpy(eye=a(jc.eye), target=a(jc.target), up=a(jc.up),
                           fov_y_deg=a(jc.fov_y_deg), width=jc.width, height=jc.height,
                           device="cpu")
    inv = InverseRenderer(ts, tc, fit=FitConfig(**fit), render=RenderConfig(method="packet", **rk))
    got = inv.fit(torch.from_numpy(tgt))
    assert inv.tracer0.packed is not None and got.steps_run == 2
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    for k in ("verts", "albedo"):
        moved = np.abs(a(ref.params[k]) - a(getattr(js.tris, k)))
        assert moved.max() > 1e-4, k
        np.testing.assert_allclose(got.params[k].numpy(), a(ref.params[k]), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------
PACKET_PY = pathlib.Path(kp.__file__)


def test_every_launch_is_made_on_its_tensors_card():
    tree = ast.parse(PACKET_PY.read_text())
    launches = {n.attr for n in ast.walk(tree)
                if isinstance(n, ast.Attribute) and n.attr.startswith("tpurt_")
                and n.attr != "tpurt_error_string"}
    assert launches == {"tpurt_packet_closest", "tpurt_packet_occluded", "tpurt_packet_knear"}
    assert launches_outside_on_device(PACKET_PY) == []
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_the_rings_packet_route_reaches_only_the_wrappers():
    """dist/ring.py's packet engine calls the three wrappers, which launch
    their kernels on a CUDA tensor (above), and no twin: neither a packet
    twin nor any other *_ref walk is named there, nothing launches a
    kernel outside a wrapper, and no try swallows a failed launch.  A
    PackedBVH gets "packet" unless "binary" is named; an engine that does
    not walk the tree is refused."""
    path = pathlib.Path(ring_mod.__file__)
    tree = ast.parse(path.read_text())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert {"traverse_packet", "occluded_packet", "k_nearest_ids_packet"} <= names
    assert not {n for n in names if n.endswith("_ref") or n.startswith("tpurt_")}
    assert launches_outside_on_device(path) == []
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    packed = _case("cornell64")["packed"]
    assert ring_mod.engine_of(packed) == "packet"
    assert ring_mod.engine_of(packed, "binary") == "binary"
    for engine in ("wide8", "brute", "pallas"):
        with pytest.raises(ValueError):
            ring_mod.engine_of(packed, engine)


def test_a_tensor_off_the_cpu_never_reaches_a_twin(monkeypatch):
    """A meta tensor (neither CPU nor CUDA) is refused before any twin or
    kernel runs, through the wrappers and through the ring's local steps
    over a PackedBVH (engine "packet", named or by default); k outside
    [1, KMAX] is refused."""
    case = _case("cornell64")
    for name in ("traverse_packet_ref", "occluded_packet_ref", "k_nearest_ids_packet_ref"):
        monkeypatch.setattr(kp, name, lambda *a, **kw: pytest.fail("a twin ran"))
    meta = Rays(o=torch.zeros(4, 3, device="meta"), d=torch.zeros(4, 3, device="meta"))
    pk = case["packed"]
    on_meta = dataclasses.replace(pk, **{f: getattr(pk, f).to("meta") for f in (
        "node_f32", "node_i32", "tri_rows", "tri_ids")})
    kp.reset_launches()
    o, d = meta.o, meta.d
    tm = torch.ones(4, device="meta")
    ring_calls = [
        call for engine in (None, "packet") for call in (
            lambda e=engine: ring_mod.closest_step(o, d, ring_mod.closest_init(4, "meta"),
                                                   on_meta, engine=e),
            lambda e=engine: ring_mod.occluded_step(
                o, d, tm, torch.zeros(4, dtype=torch.bool, device="meta"), on_meta, engine=e),
            lambda e=engine: ring_mod.knear_step(o, d, tm, *ring_mod.knear_init(4, 4, "meta"),
                                                 on_meta, torch.zeros(1, 15, device="meta"),
                                                 4, BAND, engine=e))]
    for call in [lambda: kp.traverse_packet(meta, on_meta),
                 lambda: kp.occluded_packet(meta, on_meta, 1.0),
                 lambda: kp.k_nearest_ids_packet(meta, on_meta, 4, BAND)] + ring_calls:
        with pytest.raises(ValueError):
            call()
    assert kp.LAUNCHES == dict.fromkeys(kp.LAUNCHES, 0)
    rays = _trays(case["o"][:4], case["d"][:4])
    for k in (0, kp.KMAX + 1):
        with pytest.raises(ValueError, match="outside"):
            kp.k_nearest_ids_packet(rays, pk, k, BAND)
