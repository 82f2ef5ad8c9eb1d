"""tpurt_torch's BVH8 walks against tpurt's.

The port's plain-torch twins (what the wrappers run on CPU tensors) take a
WideBVH built by tpurt, handed over as numpy arrays, and are compared with
tpurt's Pallas kernels run as tpurt's own tests run them on the CPU
(interpret mode), and with tpurt's brute-force oracles.

Tolerances, with their reasons:
- hit ids and blocked flags: bitwise.
- t, u, v: bitwise against tpurt's Möller–Trumbore formula evaluated in
  numpy float32 on the winning triangle; within 1e-4 of the interpret-mode
  kernel (measured max 7.3e-5), because XLA's CPU backend contracts a*b+c
  into FMAs inside that kernel and the port, like its CUDA kernel built with
  -fmad=false, does not.  Grazing hits amplify the last-bit differences.
- albedo and emission: bitwise; the unnormalised normal within 1e-6.
- against brute force: at most 1e-3 of rays may differ (edge ties; tpurt's
  own pallas8 differs from its brute force on 2 of 4096 cornell rays).

One inherited difference is pinned rather than compared: tpurt's _safe_inv
maps a direction component in [-1e-30, 0) to an inverse of 0, which fails
every slab test.  On its own walk such a ray therefore misses; tpurt's
(sub, 128) packet walk may still report its hit when a neighbour ray opens
the leaf.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.accel.bvh8 import build_wide as j_build_wide
from tpurt.accel.intersect import intersect_brute, occluded_brute
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.core import scene as jscene
from tpurt.core.geometry import Rays as JRays
from tpurt.kernels.traverse8 import occluded_pallas8, traverse_pallas8
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays

from tpurt_torch.accel.bvh8 import WideBVH, decode_lane_i32
from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.core.convert import wide_from_numpy
from tpurt_torch.core.geometry import T_MAX, Rays
from tpurt_torch.kernels import _build
from tpurt_torch.kernels import traverse8 as k8

WIDE_FIELDS = ("wrow", "tri_rows", "entry_node", "entry_meta", "own_node",
               "escape", "has_int", "row_tids")
GROUPS = ("miss", "inside", "zero", "tiny_neg", "tiny_neg31", "random")


def _to_port(jw) -> WideBVH:
    return wide_from_numpy(**{f: np.asarray(getattr(jw, f)) for f in WIDE_FIELDS},
                           band=jw.band, max_stack=jw.max_stack,
                           max_rows=jw.max_rows, device="cpu")


def _trays(o, d):
    return Rays(o=torch.from_numpy(o), d=torch.from_numpy(d))


def _bunny_rays():
    """64^2 primary rays of bunny-3K with 6 groups of 100 replaced: misses
    (reversed), origins on the knot's centreline (inside the tube), zero
    components (+0 and -0), tiny negative components (-1e-20 and -1e-31)
    and random rays; plus t_max values at, below and above t_min."""
    scene, cam = jscene.make_bunny_scene(num_tris=3000)
    r = j_gen_primary_rays(cam.replace(width=64, height=64))
    o, d = np.array(r.o), np.array(r.d)
    rng = np.random.default_rng(1)
    n = o.shape[0]
    groups = dict(zip(GROUPS, np.split(rng.choice(n, 600, replace=False), 6)))
    d[groups["miss"]] *= -1.0
    u = rng.uniform(0, 2 * np.pi, 100)
    rr = 0.5 * (2 + np.cos(3 * u))
    o[groups["inside"]] = np.stack(
        [rr * np.cos(2 * u), rr * np.sin(2 * u), 0.5 * -np.sin(3 * u)], -1)
    d[groups["inside"]] = rng.normal(size=(100, 3))
    d[groups["zero"], 0] = 0.0
    d[groups["zero"][:50], 2] = -0.0
    d[groups["tiny_neg"], 0] = -1e-20
    d[groups["tiny_neg31"], 0] = -1e-31
    o[groups["random"]] = rng.uniform(-2, 2, (100, 3))
    d[groups["random"]] = rng.normal(size=(100, 3))
    tmax = rng.uniform(-1, 8, n).astype(np.float32)
    tmax[groups["miss"][:40]] = 1e-4  # == t_min: an empty window
    tmax[groups["inside"][:40]] = 0.0  # the pipeline's value for a miss
    return scene.tris, o.astype(np.float32), d.astype(np.float32), tmax, groups


@pytest.fixture(scope="module")
def bunny():
    """tpurt's interpret-mode kernels, each called once (one 4096-ray
    packet, ~60 s together), and the port's twins on the same inputs."""
    tris, o, d, tmax, groups = _bunny_rays()
    jw = j_build_wide(tris, j_build_lbvh(tris))
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    jh, jsh = traverse_pallas8(jr, tris, jw, shade_out=True)
    jblk = occluded_pallas8(jr, tris, jw, jnp.asarray(tmax))
    tw = _to_port(jw)
    th, tsh = k8.traverse_wide8(_trays(o, d), tw, shade_out=True)
    tblk = k8.occluded_wide8(_trays(o, d), tw, torch.from_numpy(tmax))
    return dict(o=o, d=d, tmax=tmax, groups=groups, jw=jw, tw=tw,
                j=(jh, [np.asarray(x) for x in jsh], np.asarray(jblk)),
                t=(th, [x.numpy() for x in tsh], tblk.numpy()))


def _others(bunny):
    keep = np.ones(bunny["o"].shape[0], bool)
    keep[bunny["groups"]["tiny_neg31"]] = False
    return keep


def test_closest_ids_match_interpret_kernel(bunny):
    jh, th = bunny["j"][0], bunny["t"][0]
    keep = _others(bunny)
    jid, tid = np.asarray(jh.tri), th.tri.numpy()
    assert np.array_equal(jid[keep], tid[keep])
    # the rays cover hits, misses and every special group
    assert 0.3 < (tid >= 0).mean() < 0.95
    for g in ("inside", "zero", "tiny_neg", "random"):
        assert (tid[bunny["groups"][g]] >= 0).any(), g
    assert (tid[bunny["groups"]["miss"]] < 0).all()


def test_tiny_negative_component_misses_on_its_own_walk(bunny):
    g = bunny["groups"]["tiny_neg31"]
    assert (bunny["t"][0].tri.numpy()[g] == -1).all()
    assert not bunny["t"][2][g].any()
    # ...while tpurt's packet walk finds most of them through neighbours
    assert (np.asarray(bunny["j"][0].tri)[g] >= 0).mean() > 0.5


def test_closest_tuv_and_misses(bunny):
    jh, th = bunny["j"][0], bunny["t"][0]
    keep = _others(bunny)
    tid = th.tri.numpy()
    hit, miss = keep & (tid >= 0), tid < 0
    for a, b in ((jh.t, th.t), (jh.u, th.u), (jh.v, th.v)):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_allclose(b[hit], a[hit], rtol=0, atol=1e-4)
    assert (th.t.numpy()[miss] == np.float32(T_MAX)).all()
    assert (th.u.numpy()[miss] == 0).all() and (th.v.numpy()[miss] == 0).all()


def _mt_numpy(o, d, tri):
    """tpurt's _mt_scalar_tri in numpy float32, op by op (no contraction)."""
    return _mt_numpy_det(o, d, tri)[:3]


def _mt_numpy_det(o, d, tri):
    """_mt_numpy, also returning det."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.T
    dx, dy, dz = d.T
    ox, oy, oz = o.T
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv = det / (det * det + np.float32(1e-12))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    return t, u, v, det


def test_closest_tuv_bitwise_against_tpurt_formula(bunny):
    th = bunny["t"][0]
    tid = th.tri.numpy()
    hit = tid >= 0
    row_tids = np.asarray(bunny["jw"].row_tids)
    rows = np.asarray(bunny["jw"].tri_rows)
    where = {int(t): (r, j) for (r, j), t in np.ndenumerate(row_tids) if t >= 0}
    rj = np.array([where[int(t)] for t in tid[hit]])
    tri = rows[rj[:, 0], None, :72].reshape(-1, 8, 9)[np.arange(len(rj)), rj[:, 1]]
    t, u, v = _mt_numpy(bunny["o"][hit], bunny["d"][hit], tri)
    for ref, got in ((t, th.t), (u, th.u), (v, th.v)):
        assert np.array_equal(ref.view(np.int32), got.numpy()[hit].view(np.int32))


def test_shade_out_matches_interpret_kernel(bunny):
    (jalb, jemi, jnrm), (talb, temi, tnrm) = bunny["j"][1], bunny["t"][1]
    keep = _others(bunny)
    assert np.array_equal(jalb[keep].view(np.int32), talb[keep].view(np.int32))
    assert np.array_equal(jemi[keep].view(np.int32), temi[keep].view(np.int32))
    np.testing.assert_allclose(tnrm[keep], jnrm[keep], rtol=0, atol=1e-6)
    miss = bunny["t"][0].tri.numpy() < 0
    assert not talb[miss].any() and not temi[miss].any() and not tnrm[miss].any()


def test_occluded_matches_interpret_kernel(bunny):
    keep = _others(bunny)
    jb, tb = bunny["j"][2], bunny["t"][2]
    assert np.array_equal(jb[keep], tb[keep])
    assert 0.05 < tb.mean() < 0.95
    assert not tb[bunny["tmax"] <= 1e-4].any()  # empty windows never block


def _scalar_walk_counts(wide, o, d, kind, tmax, k=4, band=0.08):
    """The kernels' loop (traverse8.cu, walk<Visitor>) one ray at a time in
    numpy float32: a visit slab-tests its 8 children against the bound at its
    start, then takes the passing children in entry order, pushing internal
    ones and testing each row of a leaf in turn; the any-hit walk stops after
    the row that blocks.  Returns what walk_counts reports."""
    f32 = np.float32
    nodes = wide.wrow.reshape(-1, 64)
    box = nodes[:, :48].numpy().reshape(-1, 8, 6)
    meta = decode_lane_i32(nodes.view(torch.int32)[:, 48:56]).numpy()
    trows = wide.tri_rows.numpy()
    tids = decode_lane_i32(wide.tri_rows.view(torch.int32)[:, 72:80]).numpy()
    inv_all = k8._safe_inv(torch.from_numpy(d)).numpy()
    t_min = f32(DEFAULT_T_MIN)
    lo, hi = (f32(-band), f32(1.0 + band)) if kind == "knear" else (f32(0), f32(1))
    keep = k if kind == "knear" else 1
    visits = rows = 0
    seen_n, seen_r = set(), set()
    for i in range(o.shape[0]):
        tm = f32(T_MAX) if kind == "closest" else tmax[i]
        if not tm > t_min:
            continue  # an empty window starts dead
        inv, oi = inv_all[i], o[i] * inv_all[i]
        best, blocked, stack, cur = [], False, [], 0
        while cur >= 0 and not blocked:
            visits += 1
            seen_n.add(cur)
            kth = f32(best[-1][0]) if len(best) == keep else f32(T_MAX)
            upper = tm if kind == "occluded" else min(kth, tm)
            with np.errstate(over="ignore"):  # 1e30 inverses overflow to inf
                t0, t1 = box[cur, :, :3] * inv - oi, box[cur, :, 3:] * inv - oi
            near = np.maximum(np.minimum(t0, t1).max(axis=1), t_min)
            far = np.minimum(np.maximum(t0, t1).min(axis=1), upper)
            for c in np.nonzero(near <= far)[0]:
                m = int(meta[cur, c])
                if m >= 0:
                    stack.append(m)
                    continue
                for r in range(~m >> 3, (~m >> 3) + min(wide.max_rows, (~m & 7) + 1)):
                    rows += 1
                    seen_r.add(r)
                    t, u, v, det = _mt_numpy_det(o[i][None], d[i][None],
                                                 trows[r, :72].reshape(8, 9))
                    ok = ((np.abs(det) > f32(1e-12)) & (u >= lo) & (v >= lo)
                          & (u + v <= hi) & (t > t_min) & (t < tm) & (tids[r] >= 0))
                    blocked = kind == "occluded" and bool(ok.any())
                    if blocked:
                        break
                    best = sorted(set(best) | {(float(a), int(b))
                                               for a, b in zip(t[ok], tids[r][ok])})[:keep]
                if blocked:
                    break
            cur = stack.pop() if stack else -1
    return dict(visits=visits, rows=rows, distinct_nodes=len(seen_n),
                distinct_rows=len(seen_r))


@pytest.mark.parametrize("kind", ["closest", "occluded", "knear"])
def test_twin_walk_counts_follow_the_kernel_loop(bunny, kind):
    """The counts a kernel's bound is computed from: the twin's (which walks
    lockstep, a whole visit at a time) equal a one-ray-at-a-time walk in the
    kernel's loop order, where occluded8 stops at the first blocking row."""
    sl = slice(None, None, 4)
    o, d, tmax = bunny["o"][sl], bunny["d"][sl], bunny["tmax"][sl]
    rays, tw, stats = _trays(o, d), bunny["tw"], {}
    if kind == "closest":
        k8.traverse_wide8_ref(rays, tw, stats=stats)
    elif kind == "occluded":
        blk = k8.occluded_wide8_ref(rays, tw, torch.from_numpy(tmax), stats=stats)
        assert 0.05 < float(blk.float().mean()) < 0.95
    else:
        k8.k_nearest_wide8_ref(rays, tw, 4, 0.08, t_max=torch.from_numpy(tmax), stats=stats)
    assert k8.walk_counts(stats) == _scalar_walk_counts(tw, o, d, kind, tmax)


@pytest.mark.parametrize("name", ["cornell", "sponza20k"])
def test_twins_match_brute(name):
    scene = (jscene.make_cornell_box()[0] if name == "cornell"
             else jscene.make_sponza_scene(num_tris=20_000)[0])
    tris = scene.tris
    verts = np.asarray(tris.verts)
    rng = np.random.default_rng(0)
    n = 4096
    o = rng.uniform(verts.min(0), verts.max(0), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(-0.5, 3, n).astype(np.float32)
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    tw = _to_port(j_build_wide(tris, j_build_lbvh(tris)))
    ref = np.asarray(intersect_brute(jr, tris).tri)
    got = k8.traverse_wide8_ref(_trays(o, d), tw).tri.numpy()
    assert (ref != got).mean() <= 1e-3
    assert 0.3 < (got >= 0).mean()
    ref_b = np.asarray(occluded_brute(jr, tris, t_max=jnp.asarray(tmax)))
    got_b = k8.occluded_wide8_ref(_trays(o, d), tw, torch.from_numpy(tmax)).numpy()
    assert (ref_b != got_b).mean() <= 1e-3
    assert 0.05 < got_b.mean() < 0.95


def test_wrapper_takes_the_twin_for_cpu_tensors(bunny):
    o, d = bunny["o"][:512], bunny["d"][:512]
    k8.reset_launches()
    a = k8.traverse_wide8(_trays(o, d), bunny["tw"])
    b = k8.traverse_wide8_ref(_trays(o, d), bunny["tw"])
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    assert set(k8.LAUNCHES.values()) == {0}  # no kernel ran


def test_wrapper_rejects_bad_inputs(bunny):
    o, d = bunny["o"][:8], bunny["d"][:8]
    with pytest.raises(TypeError):
        k8.traverse_wide8(Rays(torch.from_numpy(o).double(), torch.from_numpy(d)),
                          bunny["tw"])
    with pytest.raises(ValueError):
        k8.occluded_wide8(_trays(o, d[:, :2].copy()), bunny["tw"], 1.0)


def test_check_stack_raises_on_oversized_topology(bunny):
    tw = bunny["tw"]
    k8._check_stack(tw)
    with pytest.raises(RuntimeError, match="stack"):
        k8._check_stack(dataclasses.replace(tw, max_stack=k8.STACKV + 1))
    with pytest.raises(RuntimeError, match="stack"):
        k8.traverse_wide8(_trays(bunny["o"][:4], bunny["d"][:4]),
                          dataclasses.replace(tw, max_stack=k8.STACKV + 1))
    # max_stack == 0 (built elsewhere): the bound is computed from the topology
    k8._check_stack(dataclasses.replace(tw, max_stack=0))


def test_failed_build_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """No toolchain: loading the kernels raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()
