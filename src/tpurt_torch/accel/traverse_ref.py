"""Stackless threaded binary-BVH walks in plain torch (counterpart of
``tpurt/accel/traverse_ref.py``): closest hit, any hit, the k nearest band
hits and the k nearest candidate occluders.  They are the ``"bvh"`` engine
and the per-ray oracle of the binary kernels.

Every ray walks its own escape chain over the DFS-ordered flat tree: a node
whose box passes the slab test is entered at index + 1 (or, for a leaf, its
triangles are tested), any other node is skipped through its escape link,
and -1 ends the walk.  The rays step in lockstep, one node a step, over the
still-walking ones.  The arithmetic is tpurt's: the slab as (lo - o) * inv
with _safe_inv and NaN-propagating min/max, Möller–Trumbore with the smooth
inverse det / (det^2 + 1e-12) in tpurt's op order, and the lexicographic
(t, id) selection.  A leaf's candidates are merged at once; the selections
do not depend on the order within a visit, so the result is the sequential
walk's.

The walk reads the tree through a layout: ``FlatLayout`` (the LBVH's flat
arrays and Morton-sorted corners, this module's functions) or the packed
rows of kernels/traverse.py: there knear_walk is knear_bin's twin, and
closest_walk and occluded_walk are the escape-order oracles of
closest_bin's and occluded_bin's near-first twins (kernels/traverse.py
near_walk).  Given a ``stats`` dict, a walk also counts itself (node
visits, leaf visits, distinct nodes and leaves;
kernels/traverse8.walk_counts reads them), adding to what the dict holds.

soft_occlusion_ref is the soft shadow model's oracle over this walk
(tpurt calls it only from its tests).
"""

from __future__ import annotations

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.accel.lbvh import BVH
from tpurt_torch.core.geometry import Hit, KHits, Rays, T_MAX, Triangles
from tpurt_torch.diff.softvis import soft_occlusion_from_ids

# Empty k-list slot id during a walk (tpurt's big_id); emitted as -1.
BIG_ID = 2**31 - 1


def safe_inv(d: torch.Tensor) -> torch.Tensor:
    """tpurt's _safe_inv: 1/d, and sign(d) * 1e30 + 1e30 for |d| <= 1e-30
    (1e30 at 0, 0 for a tiny negative)."""
    return torch.where(d.abs() > 1e-30, 1.0 / d, torch.sign(d) * 1e30 + 1e30)


def mt9(o: torch.Tensor, d: torch.Tensor, tri: torch.Tensor):
    """Möller–Trumbore of rays (A, 3) against (A, ..., 9) triangles (v0, e1,
    e2) in tpurt's _mt_scalar_tri op order -> t, u, v, det (A, ...)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    lead = (-1,) + (1,) * (tri.dim() - 2)
    ox, oy, oz = (o[:, k].reshape(lead) for k in range(3))
    dx, dy, dz = (d[:, k].reshape(lead) for k in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = det / (det * det + DET_EPS)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return t, u, v, det


class FlatLayout:
    """The LBVH's flat arrays: node boxes, escapes and leaf flags, and each
    leaf's leaf_size triangle slots from the Morton-sorted (v0, e1, e2)."""

    def __init__(self, tris: Triangles, bvh: BVH):
        if bvh.flat_escape is None:
            raise ValueError("the BVH has no flat arrays (build it with build_lbvh)")
        self.box = torch.cat([bvh.flat_lo, bvh.flat_hi], dim=1)
        self.escape = bvh.flat_escape.long()
        self.is_leaf = bvh.flat_is_leaf
        self.first, self.count = bvh.flat_first.long(), bvh.flat_count
        self.slot = torch.arange(bvh.leaf_size, device=self.box.device)
        order = bvh.tri_order.long()
        v0, v1, v2 = (c[order] for c in tris.corners())
        self.tri9 = torch.cat([v0, v1 - v0, v2 - v0], dim=1)
        self.tri_order = bvh.tri_order
        self.n = bvh.num_tris

    def leaf(self, node: torch.Tensor):
        """(A,) leaf nodes -> (A, C, 9) triangles, (A, C) ids, (A, C) valid."""
        si = (self.first[node, None] + self.slot).clamp_max(self.n - 1)
        return self.tri9[si], self.tri_order[si], self.slot < self.count[node, None]


def _slab(o, inv, box, t_min, upper):
    """(A, 3) rays, (A, 6) boxes, (A,) upper -> (A,) pass mask and (A,)
    t_near, in tpurt's order and nesting; torch.minimum/maximum propagate
    NaN like jnp's."""
    t0 = (box[:, 0:3] - o) * inv
    t1 = (box[:, 3:6] - o) * inv
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    mn, mx = torch.minimum, torch.maximum
    t_near = mx(mx(tn[:, 0], tn[:, 1]), mx(tn[:, 2], t_min))
    t_far = mn(mn(tf[:, 0], tf[:, 1]), mn(tf[:, 2], upper))
    return t_near <= t_far, t_near


def _walk(o, d, layout, t_min: float, act, upper, on_leaf, done=None,
          stats: dict | None = None) -> None:
    """Lockstep escape walk of rays `act` (indices) from node 0.  upper(act)
    is each ray's cull bound at the start of the visit, on_leaf(rays, nodes)
    tests the leaves they entered, done(rays) ends rays early."""
    dev = o.device
    inv = safe_inv(d)
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)
    cur = torch.zeros(o.shape[0], dtype=torch.int64, device=dev)
    m = layout.box.shape[0]
    if stats is not None and "visits" not in stats:
        stats.update(visits=0, rows=torch.zeros((), dtype=torch.int64, device=dev),
                     seen_nodes=torch.zeros(m, dtype=torch.bool, device=dev),
                     seen_rows=torch.zeros(m, dtype=torch.bool, device=dev))
    while act.numel():
        node = cur[act]
        boxed, _ = _slab(o[act], inv[act], layout.box[node], tmin, upper(act))
        leaf = layout.is_leaf[node]
        enter = boxed & leaf
        if stats is not None:
            stats["visits"] += act.numel()
            stats["seen_nodes"][node] = True
            stats["rows"] += enter.sum()
            stats["seen_rows"][node[enter]] = True
        if bool(enter.any()):
            on_leaf(act[enter], node[enter])
        nxt = torch.where(boxed & ~leaf, node + 1, layout.escape[node])
        cur[act] = nxt
        keep = nxt >= 0
        if done is not None:
            keep &= ~done(act)
        act = act[keep]


def blocks(t, u, v, det, tid, t_min: float, t_max) -> torch.Tensor:
    """tpurt's any-hit test of candidates (t, u, v, det) with ids tid (an
    id < 0 marks an empty slot) against the window (t_min, t_max)."""
    return ((tid >= 0) & (det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t > t_min) & (t < t_max))


def _tmax_flat(rays: Rays, t_max) -> torch.Tensor:
    """t_max (scalar or per-ray) as a flat contiguous f32 tensor."""
    if isinstance(t_max, torch.Tensor) and t_max.device != rays.o.device:
        raise ValueError(f"t_max is on {t_max.device}, rays on {rays.o.device}")
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device)
    return tm.expand(rays.shape).reshape(-1).contiguous()


class Best:
    """The closest hit so far of each of n rays by (t, id): t = T_MAX,
    u = v = 0, id = -1 until one is taken."""

    def __init__(self, n: int, dev):
        self.t = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
        self.u = torch.zeros(n, dtype=torch.float32, device=dev)
        self.v = torch.zeros_like(self.u)
        self.id = torch.full((n,), -1, dtype=torch.int32, device=dev)

    def take(self, o, d, sel, tri, tid, valid, t_min: float) -> None:
        """Test rays `sel` (indices into o, d) against their (A, C, 9)
        triangles with ids tid and slot mask valid (A, C), and keep each
        ray's lexicographic (t, id) minimum of the accepted candidates where
        it beats the best so far: the kernels' slot-by-slot `better` test,
        which is order-invariant."""
        inf = torch.tensor(float("inf"), device=o.device)
        t, u, v, det = mt9(o[sel], d[sel], tri)
        ok = (valid & (det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > t_min) & (t < T_MAX))
        tm = torch.where(ok, t, inf).amin(dim=1, keepdim=True)
        cand = ok & (t == tm)
        im = torch.where(cand, tid, BIG_ID).amin(dim=1, keepdim=True)
        j = (cand & (tid == im)).int().argmax(dim=1, keepdim=True)
        tk, ik = tm[:, 0], im[:, 0]
        tb, ib = self.t[sel], self.id[sel]
        better = ok.any(dim=1) & ((tk < tb) | ((tk == tb) & (ik < ib) & (ib >= 0)))
        s = sel[better]
        self.t[s] = tk[better]
        self.u[s] = u.gather(1, j)[better, 0]
        self.v[s] = v.gather(1, j)[better, 0]
        self.id[s] = ik[better]

    def hit(self, shape) -> Hit:
        return Hit(t=self.t.reshape(shape), u=self.u.reshape(shape),
                   v=self.v.reshape(shape), tri=self.id.reshape(shape))


def closest_walk(rays: Rays, layout, t_min: float = DEFAULT_T_MIN,
                 stats: dict | None = None) -> Hit:
    """Closest hit by (t, id); a miss is t = T_MAX, u = v = 0, tri = -1."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    best = Best(n, dev)

    def on_leaf(sel, node):
        tri, tid, valid = layout.leaf(node)
        best.take(o, d, sel, tri, tid, valid, t_min)

    _walk(o, d, layout, t_min, torch.arange(n, device=dev), lambda a: best.t[a],
          on_leaf, stats=stats)
    return best.hit(rays.shape)


def occluded_walk(rays: Rays, layout, t_max, t_min: float = DEFAULT_T_MIN,
                  stats: dict | None = None) -> torch.Tensor:
    """Any hit in (t_min, t_max) -> bool; a ray stops at its first blocking
    leaf.  Rays with t_max <= t_min start dead (they can accept nothing)."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    tmax = _tmax_flat(rays, t_max)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)

    def on_leaf(sel, node):
        tri, tid, valid = layout.leaf(node)
        t, u, v, det = mt9(o[sel], d[sel], tri)
        blocked[sel] |= (valid & blocks(t, u, v, det, tid, t_min, tmax[sel, None])).any(dim=1)

    _walk(o, d, layout, t_min, torch.nonzero(tmax > t_min)[:, 0], lambda a: tmax[a],
          on_leaf, done=lambda a: blocked[a], stats=stats)
    return blocked.reshape(rays.shape)


def knear_walk(rays: Rays, layout, k: int, band: float,
               t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
               stats: dict | None = None, empty_id: int = BIG_ID):
    """The k nearest band hits per flat ray, sorted by (t, id): returns
    (t, u, v, ids), each (N, k), empty slots (T_MAX, 0, 0, -1).  Accept:
    |det| > 1e-12, u, v >= -band, u + v <= 1 + band, t_min < t < t_max; cull
    bound min(k-th t, t_max).  Rays with t_max <= t_min start dead.

    empty_id: the id of an empty slot while walking, which decides a
    candidate at t = T_MAX (only possible with t_max > T_MAX): BIG_ID, as
    tpurt's kernels (big_id), keeps it; -1, as tpurt's per-ray walks and
    its packet and wave engines, drops it."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    tmax = _tmax_flat(rays, t_max)
    ts = torch.full((n, k), T_MAX, dtype=torch.float32, device=dev)
    us = torch.zeros((n, k), dtype=torch.float32, device=dev)
    vs = torch.zeros_like(us)
    ids = torch.full((n, k), empty_id, dtype=torch.int32, device=dev)

    def on_leaf(sel, node):
        tri, tid, valid = layout.leaf(node)
        t, u, v, det = mt9(o[sel], d[sel], tri)
        ok = (valid & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
              & (u + v <= 1.0 + band) & (t > t_min) & (t < tmax[sel, None]))
        has = ok.any(dim=1)
        sel, ok = sel[has], ok[has]
        # the k smallest (t, id) of the list and the leaf's candidates: a
        # stable sort by id, then one by t
        ct = torch.cat([ts[sel], torch.where(ok, t[has], T_MAX)], dim=1)
        ci = torch.cat([ids[sel], torch.where(ok, tid[has], BIG_ID)], dim=1)
        p = torch.sort(ci, dim=1, stable=True).indices
        q = p.gather(1, torch.sort(ct.gather(1, p), dim=1, stable=True).indices)[:, :k]
        ts[sel], ids[sel] = ct.gather(1, q), ci.gather(1, q)
        us[sel] = torch.cat([us[sel], u[has]], dim=1).gather(1, q)
        vs[sel] = torch.cat([vs[sel], v[has]], dim=1).gather(1, q)

    _walk(o, d, layout, t_min, torch.nonzero(tmax > t_min)[:, 0],
          lambda a: torch.minimum(ts[a, k - 1], tmax[a]), on_leaf, stats=stats)
    empty = ids == empty_id
    return (ts, torch.where(empty, 0.0, us), torch.where(empty, 0.0, vs),
            torch.where(empty, -1, ids))


# ---------------------------------------------------------------------------
# tpurt's names, over the LBVH's flat arrays (the "bvh" engine)
# ---------------------------------------------------------------------------
def traverse_ref(rays: Rays, tris: Triangles, bvh: BVH,
                 t_min: float = DEFAULT_T_MIN) -> Hit:
    """Closest hit per ray (tpurt's traverse_ref)."""
    return closest_walk(rays, FlatLayout(tris, bvh), t_min)


def occluded_ref(rays: Rays, tris: Triangles, bvh: BVH, t_max,
                 t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Any hit in (t_min, t_max) per ray (tpurt's occluded_ref)."""
    return occluded_walk(rays, FlatLayout(tris, bvh), t_max, t_min)


def k_nearest_ref(rays: Rays, tris: Triangles, bvh: BVH, k: int = 4,
                  band: float = 0.08, t_min: float = DEFAULT_T_MIN,
                  t_max: float = T_MAX) -> KHits:
    """The k nearest band hits with their t, u, v (tpurt's k_nearest_ref).
    The BVH must be built with boxes inflated by the same band."""
    t, u, v, ids = knear_walk(rays, FlatLayout(tris, bvh), k, band, t_min, t_max,
                              empty_id=-1)
    shape = rays.shape + (k,)
    return KHits(t=t.reshape(shape), u=u.reshape(shape), v=v.reshape(shape),
                 tri=ids.reshape(shape))


def occluder_ids_ref(rays: Rays, tris: Triangles, bvh: BVH, k: int, band: float,
                     t_min: float, t_max) -> torch.Tensor:
    """The k nearest band occluders per flat ray in (t_min, t_max) ->
    (N, k) int32, -1 padded (tpurt's occluder_ids_ref)."""
    return knear_walk(rays, FlatLayout(tris, bvh), k, band, t_min, t_max, empty_id=-1)[3]


def soft_occlusion_ref(rays: Rays, tris: Triangles, bvh: BVH, sharpness: float,
                       band: float = 0.08, t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
                       k_occ: int = 16) -> torch.Tensor:
    """Soft transmittance of each shadow segment, the product over extended
    occluders of (1 - alpha) (diff/softvis.soft_occlusion_brute's model), in
    two phases: the k_occ nearest band occluders in (t_min, 2 t_max) from
    the walk, without gradient, then soft_occlusion_from_ids over them,
    differentiable.  Equal to the brute product wherever a segment crosses
    at most k_occ extended occluders.  The BVH's boxes carry the band."""
    flat = Rays(o=rays.o.reshape(-1, 3), d=rays.d.reshape(-1, 3))
    tmax = torch.as_tensor(t_max, dtype=torch.float32, device=flat.o.device)
    tmax = tmax.expand(rays.shape).reshape(-1)
    with torch.no_grad():
        ids = occluder_ids_ref(flat, tris, bvh, k_occ, band, t_min, 2.0 * tmax)
    return soft_occlusion_from_ids(flat, tris, ids, sharpness, band, t_min,
                                   tmax).reshape(rays.shape)
