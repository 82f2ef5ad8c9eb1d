"""tpurt_torch's binary-BVH walks against tpurt's.

Two engines of the port are held here: the plain-torch twins of the binary
kernels (kernels/traverse.py, what the wrappers run on CPU tensors, over the
port's packed layout) and the ``"bvh"`` engine (accel/traverse_ref.py, over
the flat arrays).  Both packages build their trees from the same triangles
(tests/test_torch_packed.py holds those bitwise).  References:

- tpurt's per-ray walks (accel/traverse_ref.py) on bunny-3K's 64^2 rays with
  tests/test_torch_traverse8.py's special groups and on a 200-triangle random
  scene (tests/oracle/test_pallas_oracle.py's);
- tpurt's Pallas kernels in interpret mode, as tests/oracle/test_pallas_oracle.py
  runs them: the random scene's 700 rays and jittered cornell at 24^2, closest
  hit, any hit at t_max 2.5, k = 4 at band 0 and k = 8 at band 0.15.

Tolerances, with their reasons:
- closest-hit ids and blocked flags: bitwise, against both references.
- t, u, v: bitwise against tpurt's Möller–Trumbore formula evaluated in numpy
  float32 on the winning triangle; within 1e-4 of tpurt's (P2, ROADMAP queue
  3: XLA's CPU backend contracts a*b+c into FMAs, the port does not).
- k-nearest ids: bitwise, except P2 rays, where the last bits of t reorder
  two candidates whose t agree to 1e-4 (relative) or move a candidate across
  a band edge (within 1e-4).  Each such ray is explained and their count is
  pinned: on bunny-3K 3 of 4,096 rays (k = 4) and 2 (k = 8 on the shadow
  calls), 1 of 576 cornell rays (a ray on the floor's shared diagonal).
- P1 (direction components in [-1e-30, 0)) and P3 (band hits outside the
  inflated box) rays differ only from tpurt's packets; on these inputs there
  are none, which the tests pin.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.walk_loops import closest_bin_kernel_loop, occluded_bin_kernel_loop
from tests.oracle.test_pallas_oracle import _random_rays, _random_scene
from tests.test_torch_traverse8 import _bunny_rays, _mt_numpy_det, _trays
from tpurt.accel import traverse_ref as jref
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.accel.packet import pack_bvh as j_pack_bvh
from tpurt.core.geometry import Rays as JRays
from tpurt.core.scene import make_cornell_box as j_make_cornell_box
from tpurt.kernels.traverse import (
    k_nearest_ids_pallas, occluded_pallas, traverse_pallas)
from tpurt.render.camera import gen_primary_rays as j_gen_primary_rays

from tpurt_torch.accel import traverse_ref as tref
from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.core.geometry import T_MAX, Rays, Triangles
from tpurt_torch.kernels import _build
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels.traverse8 import walk_counts

BAND = 0.08
TIE_RTOL = 1e-4
EDGE_ATOL = 1e-4


def _port_tris(jt) -> Triangles:
    return Triangles.create(np.asarray(jt.verts), np.asarray(jt.faces), device="cpu")


def _tri9(tris: Triangles) -> np.ndarray:
    """(T, 9) f32: every triangle's (v0, e1, e2), as the leaf rows hold them."""
    v0, v1, v2 = (c.numpy() for c in tris.corners())
    return np.concatenate([v0, v1 - v0, v2 - v0], axis=1)


def _explain(case, ref, got, band):
    """Rays whose id lists differ, each explained as P2: every candidate in
    a differing slot has a t within TIE_RTOL of another candidate's or lies
    within EDGE_ATOL of a band edge.  Returns their indices."""
    o, d, tri9 = case["o"], case["d"], _tri9(case["tt"])
    bad = np.nonzero((ref != got).any(-1))[0]
    for i in bad:
        union = sorted({int(x) for x in np.concatenate([ref[i], got[i]]) if x >= 0})
        tuv = {x: [float(a[0]) for a in _mt_numpy_det(o[i:i + 1], d[i:i + 1], tri9[x][None])]
               for x in union}
        moved = {int(x) for x, y in zip(ref[i], got[i]) if x != y and x >= 0}
        moved |= {int(y) for x, y in zip(ref[i], got[i]) if x != y and y >= 0}
        for x in moved:
            t, u, v, _ = tuv[x]
            tie = any(abs(t - tuv[y][0]) <= TIE_RTOL * abs(t) for y in union if y != x)
            edge = min(abs(u + band), abs(v + band), abs(1 + band - u - v)) <= EDGE_ATOL
            assert tie or edge, f"ray {i}: candidate {x} ({tuv[x]}) is neither a t-tie " \
                                f"nor at a band edge; ref {ref[i]} got {got[i]}"
    return bad


# ---------------------------------------------------------------------------
# Against tpurt's per-ray walks
# ---------------------------------------------------------------------------
def _random_case():
    jt, r = _random_scene(), _random_rays()
    o, d = np.array(r.o), np.array(r.d)
    tmax = np.random.default_rng(7).uniform(-1, 8, o.shape[0]).astype(np.float32)
    return jt, o, d, tmax


@pytest.fixture(scope="module", params=["bunny3k", "random200"])
def per_ray(request):
    """tpurt's traverse_ref family and the port's twins and "bvh" engine on
    the same rays: closest and any hit on the band-0 tree, the layers call
    (k = 4, t_max = T_MAX) and the shadow call (k = 8, per-ray t_max) on the
    band-0.08 tree."""
    if request.param == "bunny3k":
        jt, o, d, tmax, _ = _bunny_rays()
    else:
        jt, o, d, tmax = _random_case()
    tt = _port_tris(jt)
    jr, tr = JRays(o=jnp.asarray(o), d=jnp.asarray(d)), _trays(o, d)
    jtm, ttm = jnp.asarray(tmax), torch.from_numpy(tmax)
    out = dict(name=request.param, o=o, d=d, tt=tt, tmax=tmax, tpurt={}, twin={}, bvh={})
    for band in (0.0, BAND):
        jb, tb = j_build_lbvh(jt, band=band), build_lbvh(tt, band=band)
        pk = pack_bvh(tt, tb, max_cut_leaves(tt.num_tris, 8))
        if band == 0.0:
            h = jref.traverse_ref(jr, jt, jb)
            out["tpurt"]["closest"] = [np.asarray(x) for x in (h.t, h.u, h.v, h.tri)]
            out["tpurt"]["occluded"] = np.asarray(jref.occluded_ref(jr, jt, jb, jtm))
            for eng, hit in (("twin", kb.traverse_packed_ref(tr, pk)),
                             ("bvh", tref.traverse_ref(tr, tt, tb))):
                out[eng]["closest"] = [x.numpy() for x in (hit.t, hit.u, hit.v, hit.tri)]
            out["twin"]["occluded"] = kb.occluded_packed_ref(tr, pk, ttm).numpy()
            out["bvh"]["occluded"] = tref.occluded_ref(tr, tt, tb, ttm).numpy()
        else:
            out["tpurt"]["layers"] = np.asarray(jref.k_nearest_ref(jr, jt, jb, k=4, band=band).tri)
            out["tpurt"]["shadow"] = np.asarray(jref.occluder_ids_ref(
                jr, jt, jb, 8, band, DEFAULT_T_MIN, jtm))
            out["twin"]["layers"] = kb.k_nearest_ids_packed_ref(tr, pk, 4, band).numpy()
            out["twin"]["shadow"] = kb.k_nearest_ids_packed_ref(tr, pk, 8, band, t_max=ttm).numpy()
            out["bvh"]["layers"] = tref.k_nearest_ref(tr, tt, tb, k=4, band=band).tri.numpy()
            out["bvh"]["shadow"] = tref.occluder_ids_ref(tr, tt, tb, 8, band, DEFAULT_T_MIN,
                                                         ttm).numpy()
    return out


@pytest.mark.parametrize("engine", ["twin", "bvh"])
def test_closest_matches_tpurt_per_ray(per_ray, engine):
    ref, got = per_ray["tpurt"]["closest"], per_ray[engine]["closest"]
    assert np.array_equal(ref[3], got[3])
    hit = got[3] >= 0
    assert 0.1 < hit.mean() < 0.95
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_allclose(b[hit], a[hit], rtol=0, atol=1e-4)
    assert (got[0][~hit] == np.float32(T_MAX)).all() and not got[1][~hit].any()
    # bitwise against tpurt's formula, op by op in numpy float32
    tri = _tri9(per_ray["tt"])[got[3][hit]]
    t, u, v, _ = _mt_numpy_det(per_ray["o"][hit], per_ray["d"][hit], tri)
    for a, b in zip((t, u, v), got[:3]):
        assert np.array_equal(a.view(np.int32), b[hit].view(np.int32))


@pytest.mark.parametrize("engine", ["twin", "bvh"])
def test_occluded_matches_tpurt_per_ray(per_ray, engine):
    ref, got = per_ray["tpurt"]["occluded"], per_ray[engine]["occluded"]
    assert np.array_equal(ref, got)
    assert 0.05 < got.mean() < 0.95
    assert not got[per_ray["tmax"] <= DEFAULT_T_MIN].any()  # empty windows never block


P2_PER_RAY = {("bunny3k", "layers"): 3, ("bunny3k", "shadow"): 2,
              ("random200", "layers"): 0, ("random200", "shadow"): 0}


@pytest.mark.parametrize("call", ["layers", "shadow"])
@pytest.mark.parametrize("engine", ["twin", "bvh"])
def test_knear_matches_tpurt_per_ray(per_ray, engine, call):
    ref, got = per_ray["tpurt"][call], per_ray[engine][call]
    p2 = _explain(per_ray, ref, got, BAND)
    assert len(p2) == P2_PER_RAY[per_ray["name"], call], p2
    filled = (got >= 0).sum(-1)
    assert (filled > 1).any() and (filled == 0).any()
    # the twin and the "bvh" engine walk the same tree in the same order
    assert np.array_equal(per_ray["twin"][call], per_ray["bvh"][call])


# ---------------------------------------------------------------------------
# Against tpurt's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["random", "cornell"])
def pallas(request):
    """tests/oracle/test_pallas_oracle.py's cases, packed by both packages
    with make_tracer's bound.  tpurt's tree is built eagerly: its jitted
    make_tracer contracts the band pad into an FMA, which moves band boxes
    by an ulp, and the kernels are compared here on the same tree."""
    if request.param == "random":
        jt, r = _random_scene(), _random_rays()
    else:
        jt = j_make_cornell_box()[0].tris
        cam = j_make_cornell_box()[1].replace(width=24, height=24)
        r = j_gen_primary_rays(cam, jnp.full((24 * 24, 2), 0.123456, jnp.float32))
        r = JRays(o=r.o.reshape(-1, 3), d=r.d.reshape(-1, 3))
    tt = _port_tris(jt)
    o, d = np.array(r.o), np.array(r.d)
    out = dict(name=request.param, o=o, d=d, tt=tt, jt=jt, r=r, packed={})
    for band in (0.0, 0.15):
        n_leaves = max_cut_leaves(tt.num_tris, 8)
        jp = j_pack_bvh(jt, j_build_lbvh(jt, band=band), n_leaves=n_leaves)
        tp = pack_bvh(tt, build_lbvh(tt, band=band), n_leaves)
        for f in ("node_f32", "node_i32", "tri_rows", "tri_ids"):
            assert np.array_equal(np.asarray(getattr(jp, f)), getattr(tp, f).numpy()), f
        out["packed"][band] = (jp, tp)
    return out


def test_closest_matches_interpret_kernel(pallas):
    jp, tp = pallas["packed"][0.0]
    ref = traverse_pallas(pallas["r"], pallas["jt"], jp)
    got = kb.traverse_packed_ref(_trays(pallas["o"], pallas["d"]), tp)
    assert np.array_equal(np.asarray(ref.tri), got.tri.numpy())
    hit = got.tri.numpy() >= 0
    assert hit.mean() > 0.1
    for a, b in ((ref.t, got.t), (ref.u, got.u), (ref.v, got.v)):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit], rtol=0, atol=1e-4)


def test_occluded_matches_interpret_kernel(pallas):
    jp, tp = pallas["packed"][0.0]
    n = pallas["o"].shape[0]
    ref = occluded_pallas(pallas["r"], pallas["jt"], jp, jnp.full((n,), 2.5, jnp.float32))
    got = kb.occluded_packed_ref(_trays(pallas["o"], pallas["d"]), tp, 2.5)
    assert np.array_equal(np.asarray(ref), got.numpy())
    assert got.any()


P2_PALLAS = {("random", 4): 0, ("random", 8): 0, ("cornell", 4): 1, ("cornell", 8): 0}


@pytest.mark.parametrize("k,band", [(4, 0.0), (8, 0.15)])
def test_knear_matches_interpret_kernel(pallas, k, band):
    jp, tp = pallas["packed"][band]
    ref = np.asarray(k_nearest_ids_pallas(pallas["r"], pallas["jt"], jp, k=k, band=band))
    got = kb.k_nearest_ids_packed_ref(_trays(pallas["o"], pallas["d"]), tp, k, band).numpy()
    p2 = _explain(pallas, ref, got, band)
    assert len(p2) == P2_PALLAS[pallas["name"], k], p2  # and no P1 or P3 ray
    assert (got >= 0).mean() > 0.05


# ---------------------------------------------------------------------------
# Walk counts, wrappers and the build
# ---------------------------------------------------------------------------
def _scalar_walk_counts(packed, o, d, kind, tmax, k=4, band=BAND):
    """The kernels' loop one ray at a time in numpy float32.  knear_bin's
    (traverse.cu knear_bin_walk) here: slab-test the node against the bound
    at the start of the visit, enter a passing internal node at node + 1,
    test a passing leaf's 8 slots, otherwise follow the escape.  closest_bin
    and occluded_bin walk near-first (closest_bin_walk, occluded_bin_walk),
    rendered in tests/walk_loops.py; occluded_bin counts half rows as rows.
    Returns what walk_counts reports."""
    if kind == "closest":
        return closest_bin_kernel_loop(packed, o, d)[1]
    if kind == "occluded":
        return occluded_bin_kernel_loop(packed, o, d, tmax)[1]
    f32 = np.float32
    nf, ni = packed.node_f32.numpy(), packed.node_i32.numpy()
    rows = packed.tri_rows.numpy()[:, :72].reshape(-1, 8, 9)
    ids = packed.tri_ids.numpy()
    inv_all = tref.safe_inv(torch.from_numpy(d)).numpy()
    t_min = f32(DEFAULT_T_MIN)
    lo, hi = f32(-band), f32(1.0 + band)
    visits = n_rows = 0
    seen_n, seen_r = set(), set()
    for i in range(o.shape[0]):
        tm = tmax[i]
        if not tm > t_min:
            continue  # an empty window starts dead
        best, node = [], 0
        while node >= 0:
            visits += 1
            seen_n.add(node)
            kth = f32(best[-1][0]) if len(best) == k else f32(T_MAX)
            upper = np.minimum(kth, tm)
            with np.errstate(over="ignore", invalid="ignore"):
                t0 = (nf[node, 0:3] - o[i]) * inv_all[i]
                t1 = (nf[node, 3:6] - o[i]) * inv_all[i]
            tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
            near = np.maximum(np.maximum(tn[0], tn[1]), np.maximum(tn[2], t_min))
            far = np.minimum(np.minimum(tf[0], tf[1]), np.minimum(tf[2], upper))
            boxed, leaf = bool(near <= far), ni[node, 3] > 0
            if boxed and leaf:
                n_rows += 1
                seen_r.add(node)
                r = ni[node, 1]
                t, u, v, det = _mt_numpy_det(o[i][None], d[i][None], rows[r])
                ok = ((np.abs(det) > f32(1e-12)) & (u >= lo) & (v >= lo) & (u + v <= hi)
                      & (t > t_min) & (t < tm) & (ids[r] >= 0))
                best = sorted(set(best) | {(float(a), int(b)) for a, b in zip(t[ok], ids[r][ok])})[:k]
            node = node + 1 if boxed and not leaf else ni[node, 0]
    return dict(visits=visits, rows=n_rows, distinct_nodes=len(seen_n),
                distinct_rows=len(seen_r))


@pytest.mark.parametrize("kind", ["closest", "occluded", "knear"])
def test_twin_walk_counts_follow_the_kernel_loop(kind):
    """The counts a kernel's bound is computed from: the twin's, accumulated
    over two chunks, equal a one-ray-at-a-time walk in the kernel's order."""
    jt, o, d, tmax, _ = _bunny_rays()
    o, d, tmax = o[::8], d[::8], tmax[::8]
    tt = _port_tris(jt)
    pk = pack_bvh(tt, build_lbvh(tt, band=BAND if kind == "knear" else 0.0),
                  max_cut_leaves(tt.num_tris, 8))
    stats = {}
    for sl in (slice(0, 200), slice(200, None)):
        rays, tm = _trays(o[sl], d[sl]), torch.from_numpy(tmax[sl])
        if kind == "closest":
            kb.traverse_packed_ref(rays, pk, stats=stats)
        elif kind == "occluded":
            kb.occluded_packed_ref(rays, pk, tm, stats=stats)
        else:
            kb.k_nearest_ids_packed_ref(rays, pk, 4, BAND, t_max=tm, stats=stats)
    got = walk_counts(stats)
    assert got == _scalar_walk_counts(pk, o, d, kind, tmax)
    assert got["rows"] > 0 and got["distinct_rows"] <= pk.num_leaves


@pytest.fixture(scope="module")
def small():
    jt, o, d, tmax = _random_case()
    tt = _port_tris(jt)
    return dict(o=o[:64], d=d[:64], tmax=tmax[:64],
                pk=pack_bvh(tt, build_lbvh(tt, band=BAND), max_cut_leaves(tt.num_tris, 8)))


def test_wrappers_take_the_twin_for_cpu_tensors(small):
    rays, pk, tm = _trays(small["o"], small["d"]), small["pk"], torch.from_numpy(small["tmax"])
    kb.reset_launches()
    a, b = kb.traverse_packed(rays, pk), kb.traverse_packed_ref(rays, pk)
    assert torch.equal(a.tri, b.tri) and torch.equal(a.t, b.t)
    assert torch.equal(kb.occluded_packed(rays, pk, tm), kb.occluded_packed_ref(rays, pk, tm))
    ids = kb.k_nearest_ids_packed(rays, pk, 8, BAND, t_max=tm)
    assert ids.dtype == torch.int32 and ids.shape == (64, 8)
    assert torch.equal(ids, kb.k_nearest_ids_packed_ref(rays, pk, 8, BAND, t_max=tm))
    assert set(kb.LAUNCHES.values()) == {0}  # no kernel ran


def test_wrappers_reject_bad_inputs(small):
    import dataclasses

    o, d, pk = small["o"], small["d"], small["pk"]
    with pytest.raises(TypeError):
        kb.traverse_packed(Rays(torch.from_numpy(o).double(), torch.from_numpy(d)), pk)
    with pytest.raises(ValueError):
        kb.occluded_packed(_trays(o, d[:, :2].copy()), pk, 1.0)
    with pytest.raises(TypeError, match="node_i32"):
        kb.traverse_packed(_trays(o, d), dataclasses.replace(pk, node_i32=pk.node_i32.float()))
    with pytest.raises(ValueError, match="tri_rows"):
        kb.traverse_packed(_trays(o, d), dataclasses.replace(pk, tri_rows=pk.tri_rows[:, :72]))
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.cat([pk.node_f32, pk.node_f32], dim=1)[:, :8]
        kb.traverse_packed(_trays(o, d), dataclasses.replace(pk, node_f32=strided))
    for k in (0, kb.KMAX + 1):
        with pytest.raises(ValueError, match="k ="):
            kb.k_nearest_ids_packed(_trays(o, d), pk, k, BAND)


def _fake_nvcc(tmp_path, script: str):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + script)
    nvcc.chmod(0o755)
    return home


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails: building raises with its output; nothing falls
    back to a twin."""
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, "echo broken >&2; exit 3\n")))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*broken"):
        _build.load()


def test_build_compiles_each_source_then_links(monkeypatch, tmp_path):
    """One nvcc per csrc/*.cu, all started before any is waited for, each to
    its own object, then one link of the objects into the named library."""
    log = tmp_path / "calls"
    script = (f'echo "$@" >> {log}\n'
              'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    monkeypatch.setenv("CUDA_HOME", str(_fake_nvcc(tmp_path, script)))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path = _build.build()
    calls = log.read_text().splitlines()
    sources = _build._sources()
    assert {"traverse.cu", "traverse8.cu"} <= {s.rsplit("/", 1)[-1] for s in sources}
    assert len(calls) == len(sources) + 1
    assert all(" -c " in c and "-fmad=false" in c for c in calls[:-1])
    assert "-shared" in calls[-1] and calls[-1].count(".o") == len(sources)
    assert path == _build.library_path() and (tmp_path / "build").exists()


def test_library_name_hashes_headers(monkeypatch, tmp_path):
    """An edited shared header changes the library's name, so a stale
    library is never loaded."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path() != first
    assert [p.rsplit("/", 1)[-1] for p in _build._inputs()] == ["a.cu", "h.cuh"]
