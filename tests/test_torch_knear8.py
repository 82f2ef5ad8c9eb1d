"""tpurt_torch's k-nearest BVH8 walk against tpurt's.

The port's plain-torch twin (what k_nearest_wide8 runs on CPU tensors) takes
a band-0.08 WideBVH built by tpurt, handed over as numpy arrays, and is
compared with tpurt's k_nearest_ids_pallas8 run as tpurt's own tests run it
on the CPU (interpret mode), and with tpurt's brute-force k_nearest_brute.
The rays are test_torch_traverse8.py's: 64x64 primary rays of bunny-3K with
special groups (misses, origins inside the tube, zero and tiny negative
direction components, random rays), and per-ray t_max at, below and above
t_min for the k = 8 call.

Tolerances, with their reasons:
- ids are bitwise equal, except on the rays explained below.
- P1 (inherited from tpurt's _safe_inv): a direction component in
  [-1e-30, 0) fails every slab test, so on its own walk such a ray finds
  nothing; tpurt's packet walk finds candidates through neighbour rays.
  Pinned: the port's lists are all -1 there.
- P3 (inherited from tpurt's band inflation): boxes are inflated by
  band * (|e1| + |e2|) per axis, which does not cover the corners of the
  band-extended triangle (reaching (1 + 2 band) e1 - band e2 from v0), so a
  band hit there may lie outside every box of its leaf.  A per-ray walk
  then never tests it; tpurt's packet walk may, through a neighbour ray.
  Such a ray is explained when every candidate it lacks lies outside its
  own inflated box.
- P2 (XLA's CPU backend contracts a*b+c into FMAs inside the interpret-mode
  kernel; the port, like its CUDA kernel built with -fmad=false, does not):
  t can differ in the last bits, which flips the order of two candidates
  whose t agree to ~1e-6, or swaps the k-th candidate with the next.  At
  most 1e-3 of the rays may differ this way, and every candidate whose slot
  differs must lie within 1e-4 (relative) of another's t or within 1e-4 of
  a band edge.
- against brute force the same rule holds (brute has no boxes, so it finds
  every P3 candidate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_traverse8 import _bunny_rays, _mt_numpy, _to_port, _trays
from tpurt.accel.bvh8 import build_wide as j_build_wide
from tpurt.accel.lbvh import build_lbvh as j_build_lbvh
from tpurt.core.geometry import Rays as JRays
from tpurt.diff.softvis import k_nearest_brute as j_k_nearest_brute
from tpurt.kernels.traverse8 import k_nearest_ids_pallas8

from tpurt_torch.core.geometry import T_MAX
from tpurt_torch.kernels import traverse8 as k8

BAND = 0.08
MAX_TIE_FRAC = 1e-3
TIE_RTOL = 1e-4
EDGE_ATOL = 1e-4


@pytest.fixture(scope="module")
def bunny():
    """tpurt's interpret-mode k-nearest kernel, called once per case (~35 s
    for k = 4, ~90 s for k = 8), and the port's twin on the same inputs."""
    tris, o, d, tmax, groups = _bunny_rays()
    jw = j_build_wide(tris, j_build_lbvh(tris, band=BAND))
    jr = JRays(o=jnp.asarray(o), d=jnp.asarray(d))
    tw = _to_port(jw)
    cases = {}
    for k, tm in ((4, None), (8, tmax)):
        kw = {} if tm is None else {"t_max": jnp.asarray(tm)}
        jid = np.asarray(k_nearest_ids_pallas8(jr, tris, jw, k=k, band=BAND, **kw))
        bt = jnp.float32(T_MAX) if tm is None else jnp.asarray(tm).reshape(-1, 1)
        bid = np.asarray(j_k_nearest_brute(jr, tris, k=k, band=BAND, t_max=bt).tri)
        tid = k8.k_nearest_wide8_ref(_trays(o, d), tw, k, BAND, t_max=(
            T_MAX if tm is None else torch.from_numpy(tm))).numpy()
        cases[k] = dict(tpurt=jid, brute=bid, port=tid, tmax=tm)
    rows, rt = np.asarray(jw.tri_rows), np.asarray(jw.row_tids)
    where = {int(t): (r, j) for (r, j), t in np.ndenumerate(rt) if t >= 0}
    return dict(o=o, d=d, groups=groups, jw=jw, tw=tw, tris=tris, cases=cases,
                rows=rows, where=where)


def _tuv(b, i, tid):
    """tpurt's Möller–Trumbore of ray i and triangle tid, numpy f32."""
    r, j = b["where"][tid]
    tri = b["rows"][r, :72].reshape(8, 9)[j][None]
    t, u, v = _mt_numpy(b["o"][i:i + 1], b["d"][i:i + 1], tri)
    return float(t[0]), float(u[0]), float(v[0])


def _outside_box(b, i, tid, t):
    """Whether ray i's hit point on tid lies outside tid's band-inflated box
    (build_lbvh's formula)."""
    verts, faces = np.asarray(b["tris"].verts), np.asarray(b["tris"].faces)
    v0, v1, v2 = verts[faces[tid]]
    lo, hi = np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2)
    pad = np.float32(BAND) * (np.abs(v1 - v0) + np.abs(v2 - v0)) + np.float32(1e-7)
    p = b["o"][i] + np.float32(t) * b["d"][i]
    return bool(((p < lo - pad) | (p > hi + pad)).any())


def _classify(b, ref, got):
    """Rays whose lists differ, split into P3 rays (every candidate missing
    from `got` lies outside its inflated box) and P2 rays (every candidate
    in a differing slot is a t-tie or at a band edge).  Fails on a ray that
    neither explains."""
    p1 = set(b["groups"]["tiny_neg31"].tolist())
    p2, p3 = [], []
    for i in np.nonzero((ref != got).any(-1))[0]:
        if i in p1:
            continue
        union = sorted({int(x) for x in np.concatenate([ref[i], got[i]]) if x >= 0})
        tuv = {x: _tuv(b, i, x) for x in union}
        missing = set(ref[i].tolist()) - set(got[i].tolist()) - {-1}
        if missing and all(_outside_box(b, i, x, tuv[x][0]) for x in missing):
            p3.append(i)
            continue
        moved = {int(x) for x, y in zip(ref[i], got[i]) if x != y and x >= 0}
        moved |= {int(y) for x, y in zip(ref[i], got[i]) if x != y and y >= 0}
        for x in moved:
            t, u, v = tuv[x]
            tie = any(abs(t - tuv[y][0]) <= TIE_RTOL * abs(t) for y in union if y != x)
            edge = min(abs(u + BAND), abs(v + BAND), abs(1 + BAND - u - v)) <= EDGE_ATOL
            assert tie or edge, f"ray {i}: candidate {x} (t={t}) is neither a t-tie " \
                                f"nor at a band edge; ref {ref[i]} got {got[i]}"
        p2.append(i)
    return p2, p3


@pytest.mark.parametrize("k", [4, 8])
def test_twin_ids_match_interpret_kernel(bunny, k):
    c = bunny["cases"][k]
    p2, _ = _classify(bunny, c["tpurt"], c["port"])
    assert len(p2) <= MAX_TIE_FRAC * c["port"].shape[0], p2
    # the lists are filled, partly filled and empty on different rays
    filled = (c["port"] >= 0).sum(-1)
    assert (filled == k).any() and (filled == 0).any() and ((filled > 0) & (filled < k)).any()


@pytest.mark.parametrize("k", [4, 8])
def test_twin_ids_match_brute(bunny, k):
    c = bunny["cases"][k]
    p2, p3 = _classify(bunny, c["brute"], c["port"])
    assert len(p2) <= MAX_TIE_FRAC * c["port"].shape[0], p2
    assert len(p3) <= MAX_TIE_FRAC * c["port"].shape[0], p3


def test_band_corner_candidates_found_only_by_the_packet_walk(bunny):
    """P3 pinned: on this ray set tpurt's packet walk reports at least one
    band-corner candidate that lies outside its own inflated box and that
    the per-ray walk cannot reach."""
    c = bunny["cases"][4]
    _, p3 = _classify(bunny, c["tpurt"], c["port"])
    assert p3


@pytest.mark.parametrize("k", [4, 8])
def test_tiny_negative_component_finds_nothing(bunny, k):
    """P1 pinned: the port's lists are empty, tpurt's packets find some."""
    c = bunny["cases"][k]
    g = bunny["groups"]["tiny_neg31"]
    assert (c["port"][g] == -1).all()
    if k == 4:
        assert (c["tpurt"][g] >= 0).any()


def test_lists_sorted_deduplicated_and_windowed(bunny):
    """Each list is sorted by (t, id) with no repeated id, -1 only at its
    end, and every t lies in (t_min, t_max)."""
    c = bunny["cases"][8]
    ids, tmax = c["port"], c["tmax"]
    for i in range(0, ids.shape[0], 7):
        row = [int(x) for x in ids[i] if x >= 0]
        assert (ids[i, len(row):] == -1).all()
        assert len(set(row)) == len(row)
        keys = [(_tuv(bunny, i, x)[0], x) for x in row]
        assert keys == sorted(keys)
        assert all(1e-4 < t < tmax[i] for t, _ in keys)
    assert not (ids[tmax <= 1e-4] >= 0).any()  # empty windows find nothing


def test_band_zero_first_slot_is_the_closest_hit(bunny):
    """With band 0 and k = 1 the k-nearest walk reduces to the closest hit."""
    o, d = bunny["o"][:1024], bunny["d"][:1024]
    ids = k8.k_nearest_wide8_ref(_trays(o, d), bunny["tw"], 1, 0.0)[:, 0]
    hit = k8.traverse_wide8_ref(_trays(o, d), bunny["tw"])
    assert torch.equal(ids, hit.tri)


def test_wrapper_takes_the_twin_for_cpu_tensors(bunny):
    o, d = bunny["o"][:512], bunny["d"][:512]
    k8.reset_launches()
    a = k8.k_nearest_wide8(_trays(o, d), bunny["tw"], 4, BAND)
    b = k8.k_nearest_wide8_ref(_trays(o, d), bunny["tw"], 4, BAND)
    assert a.dtype == torch.int32 and a.shape == (512, 4) and torch.equal(a, b)
    assert set(k8.LAUNCHES.values()) == {0}  # no kernel ran


@pytest.mark.parametrize("k", [0, 17])
def test_wrapper_rejects_k_outside_the_kernel_list(bunny, k):
    with pytest.raises(ValueError, match="k ="):
        k8.k_nearest_wide8(_trays(bunny["o"][:4], bunny["d"][:4]), bunny["tw"], k, BAND)


def test_twin_counts_its_walk(bunny):
    """Counts accumulate over chunked calls: two halves count what the whole
    batch counts."""
    o, d = bunny["o"][:256], bunny["d"][:256]
    whole, halves = {}, {}
    k8.k_nearest_wide8_ref(_trays(o, d), bunny["tw"], 4, BAND, stats=whole)
    for sl in (slice(0, 128), slice(128, 256)):
        k8.k_nearest_wide8_ref(_trays(o[sl], d[sl]), bunny["tw"], 4, BAND, stats=halves)
    got = k8.walk_counts(whole)
    assert got == k8.walk_counts(halves)
    assert got["visits"] >= 256 and got["rows"] > 0
    assert 0 < got["distinct_nodes"] <= bunny["tw"].num_wides
    assert 0 < got["distinct_rows"] <= bunny["tw"].num_rows
