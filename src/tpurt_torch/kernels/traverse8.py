"""BVH8 closest-hit, any-hit and k-nearest traversal (counterpart of
``tpurt/kernels/traverse8.py``).

``traverse_wide8``, ``occluded_wide8`` and ``k_nearest_wide8`` launch the
hand-written CUDA kernels in ``csrc/traverse8.cu`` for CUDA tensors and run
their plain-torch twins, ``traverse_wide8_ref``, ``occluded_wide8_ref`` and
``k_nearest_wide8_ref``, for CPU tensors.  There is no other route: a CUDA
tensor either reaches its kernel or the call raises.

Semantics are tpurt's: the same slab test (``lo*inv - o*inv`` with tpurt's
``_safe_inv``), the same smooth-inverse Möller–Trumbore in the same op
order, the same accept tests, the lexicographic (t, id) selection, and for
k-nearest the band test, the dedup by id and the min(k-th t, t_max) cull.  tpurt
walks (sub, 128) ray packets; both versions here walk each ray on its own
stack.  The selection is order- and superset-invariant, so the hits are the
same wherever a ray's own box tests are conservative.  The one exception is
inherited from ``_safe_inv``: a direction component in [-1e-30, 0) gets an
inverse of 0, which fails every slab test, so such a ray misses on its own
walk while a tpurt packet may still find its hit through a neighbour ray.

The twin is a lockstep loop over all rays with an (R, STACKV) stack tensor;
it visits nodes, pushes and pops in exactly the kernel's order, so the two
agree bit for bit when the kernel is built without FMA contraction.  Given a
``stats`` dict, a twin also counts its walk (off by default), adding to what
the dict already holds, so chunked calls accumulate: node visits, leaf rows
tested, and the distinct nodes and rows touched (``walk_counts`` reads
them), from which a kernel's least time on the card (its bound) is computed.
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.accel.bvh8 import ENTRIES, WideBVH, decode_lane_i32, stack_bound
from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.accel.traverse_ref import BIG_ID as _BIG_ID
from tpurt_torch.accel.traverse_ref import _tmax_flat, blocks, mt9
from tpurt_torch.accel.traverse_ref import safe_inv as _safe_inv
from tpurt_torch.core.geometry import Hit, Rays, T_MAX
from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream

# Per-ray stack depth; tpurt's STACKV.  _check_stack guarantees a topology's
# worst case fits, since a push past the end would drop a subtree silently.
STACKV = 192

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"closest8": 0, "occluded8": 0, "knear8": 0}
# Largest k of the k-nearest kernel (its compile-time list length).
KMAX = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_stack(wide: WideBVH) -> None:
    """Raise when the topology's worst-case stack occupancy exceeds STACKV.
    max_stack == 0 means the WideBVH was built elsewhere: compute it."""
    bound = wide.max_stack
    if bound == 0:
        bound = stack_bound(wide.entry_meta.cpu().numpy())
    if bound > STACKV:
        raise RuntimeError(
            f"BVH8 worst-case stack occupancy {bound} exceeds the kernel "
            f"stack ({STACKV}); rebuild with smaller fat_tris")


# ---------------------------------------------------------------------------
# Plain-torch twins
# ---------------------------------------------------------------------------
def _slab8(oi, inv, box, t_min, t_upper):
    """(A, 3) o*inv, (A, 3) inv, (A, 8, 6) child boxes, (A,) upper ->
    (A, 8) pass mask.  torch.minimum/maximum propagate NaN like jnp's."""
    ix, iy, iz = (inv[:, k, None] for k in range(3))
    oix, oiy, oiz = (oi[:, k, None] for k in range(3))
    tx0, tx1 = box[..., 0] * ix - oix, box[..., 3] * ix - oix
    ty0, ty1 = box[..., 1] * iy - oiy, box[..., 4] * iy - oiy
    tz0, tz1 = box[..., 2] * iz - oiz, box[..., 5] * iz - oiz
    mn, mx = torch.minimum, torch.maximum
    t_near = mx(mx(mn(tx0, tx1), mn(ty0, ty1)), mx(mn(tz0, tz1), t_min))
    t_far = mn(mn(mx(tx0, tx1), mx(ty0, ty1)), mn(mx(tz0, tz1), t_upper[:, None]))
    return t_near <= t_far


def _mt_rows(o, d, trow):
    """Möller–Trumbore of rays (A, 3) against the 8 triangles of each of
    their K rows (A, K, 128) in tpurt's op order -> t, u, v, det (A, K, 8)."""
    return mt9(o, d, trow[..., :72].unflatten(-1, (8, 9)))


def _row_ids(trow):
    """(A, K, 128) rows -> (A, K, 8) decoded triangle ids."""
    return decode_lane_i32(trow[..., 72:80].contiguous().view(torch.int32))


def _shade_lanes(trow):
    """(A, K, 128) rows -> (A, K, 8, 9): albedo, emission and unnormalised
    e1 x e2 of every triangle, in the kernel's op order."""
    e1x, e1y, e1z, e2x, e2y, e2z = trow[..., :72].unflatten(-1, (8, 9))[
        ..., 3:9].unbind(-1)
    nrm = torch.stack([e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                       e1x * e2y - e1y * e2x], dim=-1)
    return torch.cat([trow[..., 80:104].unflatten(-1, (8, 3)),
                      trow[..., 104:128].unflatten(-1, (8, 3)), nrm], dim=-1)


class _Walk:
    """Shared lockstep stack walk: the per-visit node decode, child slab
    tests, leaf-row gather, pushes and pops of every still-walking ray."""

    def __init__(self, o, d, wide: WideBVH, t_min: float, stats: dict | None = None):
        _check_stack(wide)
        n, dev = o.shape[0], o.device
        self.wide = wide
        self.inv = _safe_inv(d)
        self.oi = o * self.inv
        self.tmin_t = torch.tensor(t_min, dtype=torch.float32, device=dev)
        self.nodes = wide.wrow.reshape(-1, 64)
        self.nodes_i = self.nodes.view(torch.int32)
        self.stack = torch.zeros((n, STACKV), dtype=torch.int32, device=dev)
        self.sp = torch.zeros(n, dtype=torch.int64, device=dev)
        self.cur = torch.zeros(n, dtype=torch.int64, device=dev)
        self.stats = stats
        if stats is not None and "visits" not in stats:
            stats.update(
                visits=0, rows=torch.zeros((), dtype=torch.int64, device=dev),
                seen_nodes=torch.zeros(self.nodes.shape[0], dtype=torch.bool, device=dev),
                seen_rows=torch.zeros(wide.tri_rows.shape[0], dtype=torch.bool,
                                      device=dev))

    def visit(self, act, upper):
        """Slab-test the 8 children of each active ray's current node.
        Returns (leaf rows (A, 8*max_rows, 128), row-slot mask, push mask,
        metas).  Slots run child by child, row by row: the kernel's order."""
        rec = self.nodes[self.cur[act]]
        meta = decode_lane_i32(self.nodes_i[self.cur[act]][:, 48:56])
        hit = _slab8(self.oi[act], self.inv[act],
                     rec[:, :48].unflatten(-1, (ENTRIES, 6)), self.tmin_t, upper)
        nm = ~meta
        r = torch.arange(self.wide.max_rows, device=act.device)
        slot = ((hit & (meta < 0))[..., None]
                & (r < ((nm & 7) + 1)[..., None]))        # (A, 8, max_rows)
        ridx = torch.where(slot, (nm >> 3)[..., None] + r, 0).flatten(1)
        if self.stats is not None:
            self.stats["visits"] += act.numel()
            self.stats["seen_nodes"][self.cur[act]] = True
            self.ridx = ridx
        return (self.wide.tri_rows[ridx], slot.flatten(1),
                hit & (meta >= 0), meta)

    def count_rows(self, tested, n_tested=None):
        """Count the last visit's leaf rows that the kernel tests, a mask
        over its slots (A, 8*max_rows); n_tested: what it counts instead of
        their number (occluded8's half rows)."""
        if self.stats is not None:
            self.stats["rows"] += tested.sum() if n_tested is None else n_tested
            self.stats["seen_rows"][self.ridx[tested]] = True

    def push_pop(self, act, push, meta, keep=None):
        """Push passing internal children in entry order (LIFO), then pop
        the next node; returns the rays that still have one (and, given
        the mask keep, are kept).  A ray that does not push a child writes
        its own stack slot back unchanged: no host sync a push."""
        sp = self.sp[act]
        for c in range(ENTRIES):
            p = push[:, c]
            idx = torch.clamp_max(sp, STACKV - 1)
            self.stack[act, idx] = torch.where(p, meta[:, c], self.stack[act, idx])
            sp = sp + p
        more = sp > 0
        top = self.stack[act, torch.clamp(sp - 1, 0, STACKV - 1)].long()
        self.cur[act] = torch.where(more, top, -1)
        self.sp[act] = torch.clamp_min(sp - 1, 0)
        return act[more if keep is None else more & keep]


def traverse_wide8_ref(rays: Rays, wide: WideBVH, t_min: float = DEFAULT_T_MIN,
                       shade_out: bool = False, stats: dict | None = None):
    """Plain-torch twin of the closest-hit kernel; same returns as
    traverse_wide8.  stats: a dict that accumulates the walk's counts."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    w = _Walk(o, d, wide, t_min, stats)
    t_b = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    u_b = torch.zeros(n, dtype=torch.float32, device=dev)
    v_b = torch.zeros_like(u_b)
    id_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sh_b = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        trow, slot, push, meta = w.visit(act, t_b[act])
        w.count_rows(slot)
        t, u, v, det = _mt_rows(o[act], d[act], trow)
        tid = _row_ids(trow)
        ok = (slot[..., None] & (det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > t_min) & (tid >= 0) & (t < T_MAX))
        ok, t, u, v, tid = (x.flatten(1) for x in (ok, t, u, v, tid))
        # lexicographic (t, id) minimum of the visit's accepted candidates;
        # order-invariant, so equal to the kernel's one-by-one updates
        tm = torch.where(ok, t, inf).amin(dim=1, keepdim=True)
        cand = ok & (t == tm)
        im = torch.where(cand, tid, torch.iinfo(torch.int32).max).amin(
            dim=1, keepdim=True)
        k = (cand & (tid == im)).int().argmax(dim=1, keepdim=True)
        tk, ik = tm[:, 0], im[:, 0]
        tb, ib = t_b[act], id_b[act]
        better = ok.any(dim=1) & ((tk < tb) | ((tk == tb) & (ik < ib) & (ib >= 0)))
        # the rays without a better hit write their own values back: no
        # host sync a visit
        t_b[act] = torch.where(better, tk, tb)
        u_b[act] = torch.where(better, u.gather(1, k)[:, 0], u_b[act])
        v_b[act] = torch.where(better, v.gather(1, k)[:, 0], v_b[act])
        id_b[act] = torch.where(better, ik, ib)
        if shade_out:
            sh = _shade_lanes(trow).flatten(1, 2)
            pick = sh.gather(1, k[:, :, None].expand(-1, 1, sh.shape[-1]))[:, 0]
            sh_b[act] = torch.where(better[:, None], pick, sh_b[act])
        act = w.push_pop(act, push, meta)
    shape = rays.shape
    hit = Hit(t=t_b.reshape(shape), u=u_b.reshape(shape), v=v_b.reshape(shape),
              tri=id_b.reshape(shape))
    if not shade_out:
        return hit
    return hit, tuple(sh_b[:, 3 * k:3 * k + 3].reshape(*shape, 3)
                      for k in range(3))


def walk_counts(stats: dict) -> dict:
    """A twin's walk counts as ints: node visits, leaf rows tested, distinct
    nodes and distinct leaf rows touched."""
    return {"visits": int(stats["visits"]), "rows": int(stats["rows"]),
            "distinct_nodes": int(stats["seen_nodes"].sum()),
            "distinct_rows": int(stats["seen_rows"].sum())}


def occluded_wide8_ref(rays: Rays, wide: WideBVH, t_max,
                       t_min: float = DEFAULT_T_MIN,
                       stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of the any-hit kernel: True where a triangle lies at
    t_min < t < t_max.  Rays with t_max <= t_min start dead.  stats: a dict
    that accumulates the walk's counts, half rows as rows (the kernel tests
    a row as two half rows); a blocked ray's last visit counts its half rows
    up to the first blocking one, where the kernel stops."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    tmax = _tmax_flat(rays, t_max)
    w = _Walk(o, d, wide, t_min, stats)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    act = torch.nonzero(tmax > t_min)[:, 0]
    while act.numel():
        trow, slot, push, meta = w.visit(act, tmax[act])
        t, u, v, det = _mt_rows(o[act], d[act], trow)
        tid = _row_ids(trow)
        ok = slot[..., None] & blocks(t, u, v, det, tid, t_min, tmax[act, None, None])
        half = ok.unflatten(-1, (2, 4)).any(-1).flatten(1)   # (A, 16*max_rows)
        tested = slot.repeat_interleave(2, dim=1) & (half.cumsum(dim=1) - half.long() == 0)
        w.count_rows(tested.unflatten(1, (-1, 2)).any(-1), tested.sum())
        hit = half.any(dim=1)
        blocked[act] |= hit
        act = w.push_pop(act, push, meta, keep=~hit)
    return blocked.reshape(rays.shape)


def _lexsort(t, ids):
    """Sort each row by (t, id): a stable sort by id, then one by t."""
    ids, p = torch.sort(ids, dim=1, stable=True)
    t, q = torch.sort(t.gather(1, p), dim=1, stable=True)
    return t, ids.gather(1, q)


def _merge_k(ts, ids, ct, ci, k: int):
    """The k smallest distinct (t, id) of a sorted list and a visit's
    candidates (non-candidates are (T_MAX, _BIG_ID)).  Copies of one triangle
    carry the same t, so after the sort they are neighbours."""
    t, i = _lexsort(torch.cat([ts, ct], dim=1), torch.cat([ids, ci], dim=1))
    dup = torch.zeros_like(i, dtype=torch.bool)
    dup[:, 1:] = (i[:, 1:] == i[:, :-1]) & (i[:, 1:] != _BIG_ID)
    t, i = _lexsort(torch.where(dup, T_MAX, t), torch.where(dup, _BIG_ID, i))
    return t[:, :k], i[:, :k]


def k_nearest_wide8_ref(rays: Rays, wide: WideBVH, k: int, band: float,
                        t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of the k-nearest kernel; same returns as
    k_nearest_wide8.  A visit's candidates merge into the k-list at once
    (dedup, sort by (t, id), keep k), which equals the kernel's one-by-one
    insertion: a node is culled only when it cannot hold a final candidate,
    so insertion order does not change the result.  stats: a dict that
    accumulates the walk's counts."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    tmax = _tmax_flat(rays, t_max)
    w = _Walk(o, d, wide, t_min, stats)
    ts = torch.full((n, k), T_MAX, dtype=torch.float32, device=dev)
    ids = torch.full((n, k), _BIG_ID, dtype=torch.int32, device=dev)
    act = torch.nonzero(tmax > t_min)[:, 0]  # an empty window starts dead
    while act.numel():
        trow, slot, push, meta = w.visit(act, torch.minimum(ts[act, k - 1], tmax[act]))
        w.count_rows(slot)
        t, u, v, det = _mt_rows(o[act], d[act], trow)
        tid = _row_ids(trow)
        ok = (slot[..., None] & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
              & (u + v <= 1.0 + band) & (t > t_min) & (t < tmax[act, None, None])
              & (tid >= 0))
        ok, t, tid = ok.flatten(1), t.flatten(1), tid.flatten(1)
        has = ok.any(dim=1)
        n_has = int(has.sum())  # the one host sync of the merge
        if n_has:
            h = torch.nonzero_static(has, size=n_has)[:, 0]
            sel, ok = act[h], ok[h]
            ts[sel], ids[sel] = _merge_k(
                ts[sel], ids[sel], torch.where(ok, t[h], T_MAX),
                torch.where(ok, tid[h], _BIG_ID), k)
        act = w.push_pop(act, push, meta)
    return torch.where(ids == _BIG_ID, -1, ids)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check_inputs(rays: Rays, wide: WideBVH):
    """Raise on anything the kernels do not take; returns flat (o, d)."""
    o, d = rays.o, rays.d
    if o.shape != d.shape or o.shape[-1:] != (3,):
        raise ValueError(f"rays.o {tuple(o.shape)} / rays.d {tuple(d.shape)}")
    dev = o.device
    for name, x, dt in (("rays.o", o, torch.float32), ("rays.d", d, torch.float32),
                        ("wide.wrow", wide.wrow, torch.float32),
                        ("wide.tri_rows", wide.tri_rows, torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if wide.wrow.shape[-1] != 128 or wide.tri_rows.shape[-1] != 128:
        raise ValueError("wide rows must be (*, 128)")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return o.reshape(-1, 3), d.reshape(-1, 3)


def traverse_wide8(rays: Rays, wide: WideBVH, t_min: float = DEFAULT_T_MIN,
                   shade_out: bool = False):
    """Closest hit per ray over the WideBVH.

    Returns a Hit (t = T_MAX, u = v = 0, tri = -1 on a miss); with
    shade_out=True returns (Hit, (albedo, emission, normal)), each (..., 3):
    the winning triangle's albedo, emission and unnormalised e1 x e2
    (zeros on a miss)."""
    o, d = _check_inputs(rays, wide)
    if o.device.type == "cpu":
        return traverse_wide8_ref(rays, wide, t_min, shade_out)
    _check_stack(wide)
    _build.check_aligned(wide.wrow.data_ptr(), wide.tri_rows.data_ptr())
    lib = _build.load()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t = torch.empty(n, **f32)
    u = torch.empty(n, **f32)
    v = torch.empty(n, **f32)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    sh = [torch.empty((n, 3), **f32) for _ in range(3)] if shade_out else []
    null = ctypes.c_void_p(None)
    # the persistent warps' ray counter, fresh for every launch
    nxt = torch.zeros(1, dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_closest8(
            _ptr(wide.wrow), _ptr(wide.tri_rows), _ptr(o), _ptr(d), n,
            wide.max_rows, ctypes.c_float(t_min), _ptr(t), _ptr(u), _ptr(v),
            _ptr(tri), *([_ptr(x) for x in sh] if shade_out else [null] * 3),
            _ptr(nxt), _stream(o.device))
    if err:
        raise RuntimeError(f"closest8 kernel launch failed: {_build.error_string(err)}")
    LAUNCHES["closest8"] += 1
    shape = rays.shape
    hit = Hit(t=t.reshape(shape), u=u.reshape(shape), v=v.reshape(shape),
              tri=tri.reshape(shape))
    if not shade_out:
        return hit
    return hit, tuple(x.reshape(*shape, 3) for x in sh)


def occluded_wide8(rays: Rays, wide: WideBVH, t_max,
                   t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Any hit in (t_min, t_max) per ray -> bool (...).  t_max is a scalar
    or per-ray; rays with t_max <= t_min start dead (the hard render gives
    missed primary rays t_max = 0)."""
    o, d = _check_inputs(rays, wide)
    if o.device.type == "cpu":
        return occluded_wide8_ref(rays, wide, t_max, t_min)
    tmax = _tmax_flat(rays, t_max)
    _check_stack(wide)
    _build.check_aligned(wide.wrow.data_ptr(), wide.tri_rows.data_ptr())
    lib = _build.load()
    n = o.shape[0]
    blk = torch.empty(n, dtype=torch.uint8, device=o.device)
    # the persistent warps' ray counter, fresh for every launch
    nxt = torch.zeros(1, dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_occluded8(
            _ptr(wide.wrow), _ptr(wide.tri_rows), _ptr(o), _ptr(d), _ptr(tmax), n,
            wide.max_rows, ctypes.c_float(t_min), _ptr(blk), _ptr(nxt), _stream(o.device))
    if err:
        raise RuntimeError(f"occluded8 kernel launch failed: {_build.error_string(err)}")
    LAUNCHES["occluded8"] += 1
    return blk.bool().reshape(rays.shape)


def k_nearest_wide8(rays: Rays, wide: WideBVH, k: int, band: float,
                    t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> torch.Tensor:
    """The k nearest extended (band) hits per ray -> (N, k) int32 triangle
    ids over the flattened rays, sorted by (t, id), deduplicated, -1 padded.
    Accept test: |det| > 1e-12, u, v >= -band, u + v <= 1 + band,
    t_min < t < t_max; t_max is a scalar or per ray, and rays with
    t_max <= t_min start dead.  Node boxes are culled against
    min(k-th t, t_max).  1 <= k <= KMAX."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"k = {k} outside [1, {KMAX}]")
    o, d = _check_inputs(rays, wide)
    if o.device.type == "cpu":
        return k_nearest_wide8_ref(rays, wide, k, band, t_min, t_max)
    tmax = _tmax_flat(rays, t_max)
    _check_stack(wide)
    _build.check_aligned(wide.wrow.data_ptr(), wide.tri_rows.data_ptr())
    lib = _build.load()
    n = o.shape[0]
    ids = torch.empty((n, k), dtype=torch.int32, device=o.device)
    # the persistent warps' ray counter, fresh for every launch
    nxt = torch.zeros(1, dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_knear8(
            _ptr(wide.wrow), _ptr(wide.tri_rows), _ptr(o), _ptr(d), _ptr(tmax), n,
            wide.max_rows, ctypes.c_float(t_min), k, ctypes.c_float(-band),
            ctypes.c_float(1.0 + band), _ptr(ids), _ptr(nxt), _stream(o.device))
    if err:
        raise RuntimeError(f"knear8 kernel launch failed: {_build.error_string(err)}")
    LAUNCHES["knear8"] += 1
    return ids
