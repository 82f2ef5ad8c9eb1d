"""BVH8 closest-hit and any-hit traversal (counterpart of
``tpurt/kernels/traverse8.py``).

``traverse_wide8`` and ``occluded_wide8`` launch the hand-written CUDA
kernels in ``csrc/traverse8.cu`` for CUDA tensors and run their plain-torch
twins, ``traverse_wide8_ref`` and ``occluded_wide8_ref``, for CPU tensors.
There is no other route: a CUDA tensor either reaches its kernel or the call
raises.

Semantics are tpurt's: the same slab test (``lo*inv - o*inv`` with tpurt's
``_safe_inv``), the same smooth-inverse Möller–Trumbore in the same op
order, the same accept test, and the lexicographic (t, id) selection.  tpurt
walks (sub, 128) ray packets; both versions here walk each ray on its own
stack.  The selection is order- and superset-invariant, so the hits are the
same wherever a ray's own box tests are conservative.  The one exception is
inherited from ``_safe_inv``: a direction component in [-1e-30, 0) gets an
inverse of 0, which fails every slab test, so such a ray misses on its own
walk while a tpurt packet may still find its hit through a neighbour ray.

The twin is a lockstep loop over all rays with an (R, STACKV) stack tensor;
it visits nodes, pushes and pops in exactly the kernel's order, so the two
agree bit for bit when the kernel is built without FMA contraction.
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.accel.bvh8 import ENTRIES, WideBVH, decode_lane_i32, stack_bound
from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.core.geometry import Hit, Rays, T_MAX
from tpurt_torch.kernels import _build

# Per-ray stack depth; tpurt's STACKV.  _check_stack guarantees a topology's
# worst case fits, since a push past the end would drop a subtree silently.
STACKV = 192

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"closest8": 0, "occluded8": 0}


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
def _safe_inv(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d.abs() > 1e-30, 1.0 / d, torch.sign(d) * 1e30 + 1e30)


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
    tri = trow[..., :72].unflatten(-1, (8, 9))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri.unbind(-1)
    ox, oy, oz = (o[:, k, None, None] for k in range(3))
    dx, dy, dz = (d[:, k, None, None] for k in range(3))
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

    def __init__(self, o, d, wide: WideBVH, t_min: float):
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

    def visit(self, act, upper):
        """Slab-test the 8 children of each active ray's current node.
        Returns (leaf rows (A, 8*max_rows, 128), row-slot mask, push mask,
        metas)."""
        rec = self.nodes[self.cur[act]]
        meta = decode_lane_i32(self.nodes_i[self.cur[act]][:, 48:56])
        hit = _slab8(self.oi[act], self.inv[act],
                     rec[:, :48].unflatten(-1, (ENTRIES, 6)), self.tmin_t, upper)
        nm = ~meta
        r = torch.arange(self.wide.max_rows, device=act.device)
        slot = ((hit & (meta < 0))[..., None]
                & (r < ((nm & 7) + 1)[..., None]))        # (A, 8, max_rows)
        ridx = torch.where(slot, (nm >> 3)[..., None] + r, 0).flatten(1)
        return (self.wide.tri_rows[ridx], slot.flatten(1),
                hit & (meta >= 0), meta)

    def push_pop(self, act, push, meta):
        """Push passing internal children in entry order (LIFO), then pop
        the next node; returns the rays that still have one."""
        sp = self.sp[act]
        for c in range(ENTRIES):
            p = push[:, c]
            idx = torch.clamp_max(sp, STACKV - 1)
            self.stack[act[p], idx[p]] = meta[p, c]
            sp = sp + p
        more = sp > 0
        top = self.stack[act, torch.clamp(sp - 1, 0, STACKV - 1)].long()
        self.cur[act] = torch.where(more, top, -1)
        self.sp[act] = torch.clamp_min(sp - 1, 0)
        return act[more]


def traverse_wide8_ref(rays: Rays, wide: WideBVH, t_min: float = DEFAULT_T_MIN,
                       shade_out: bool = False):
    """Plain-torch twin of the closest-hit kernel; same returns as
    traverse_wide8."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    w = _Walk(o, d, wide, t_min)
    t_b = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)
    u_b = torch.zeros(n, dtype=torch.float32, device=dev)
    v_b = torch.zeros_like(u_b)
    id_b = torch.full((n,), -1, dtype=torch.int32, device=dev)
    sh_b = torch.zeros((n, 9), dtype=torch.float32, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    act = torch.arange(n, device=dev)
    while act.numel():
        trow, slot, push, meta = w.visit(act, t_b[act])
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
        sel = act[better]
        t_b[sel] = tk[better]
        u_b[sel] = u.gather(1, k)[better, 0]
        v_b[sel] = v.gather(1, k)[better, 0]
        id_b[sel] = ik[better]
        if shade_out:
            sh = _shade_lanes(trow).flatten(1, 2)
            sh_b[sel] = sh[better, k[better, 0]]
        act = w.push_pop(act, push, meta)
    shape = rays.shape
    hit = Hit(t=t_b.reshape(shape), u=u_b.reshape(shape), v=v_b.reshape(shape),
              tri=id_b.reshape(shape))
    if not shade_out:
        return hit
    return hit, tuple(sh_b[:, 3 * k:3 * k + 3].reshape(*shape, 3)
                      for k in range(3))


def _tmax_flat(rays: Rays, t_max) -> torch.Tensor:
    """t_max (scalar or per-ray) as a flat contiguous f32 tensor."""
    if isinstance(t_max, torch.Tensor) and t_max.device != rays.o.device:
        raise ValueError(f"t_max is on {t_max.device}, rays on {rays.o.device}")
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device)
    return tm.expand(rays.shape).reshape(-1).contiguous()


def occluded_wide8_ref(rays: Rays, wide: WideBVH, t_max,
                       t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Plain-torch twin of the any-hit kernel: True where a triangle lies at
    t_min < t < t_max.  Rays with t_max <= t_min start dead."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    tmax = _tmax_flat(rays, t_max)
    w = _Walk(o, d, wide, t_min)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    act = torch.nonzero(tmax > t_min)[:, 0]
    while act.numel():
        trow, slot, push, meta = w.visit(act, tmax[act])
        t, u, v, det = _mt_rows(o[act], d[act], trow)
        tid = _row_ids(trow)
        ok = (slot[..., None] & (det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t > t_min) & (t < tmax[act, None, None])
              & (tid >= 0))
        hit = ok.flatten(1).any(dim=1)
        blocked[act[hit]] = True
        act = w.push_pop(act, push, meta)
        act = act[~blocked[act]]
    return blocked.reshape(rays.shape)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


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
    lib = _build.load()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t = torch.empty(n, **f32)
    u = torch.empty(n, **f32)
    v = torch.empty(n, **f32)
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    sh = [torch.empty((n, 3), **f32) for _ in range(3)] if shade_out else []
    null = ctypes.c_void_p(None)
    err = lib.tpurt_closest8(
        _ptr(wide.wrow), _ptr(wide.tri_rows), _ptr(o), _ptr(d), n,
        wide.max_rows, ctypes.c_float(t_min), _ptr(t), _ptr(u), _ptr(v),
        _ptr(tri), *([_ptr(x) for x in sh] if shade_out else [null] * 3),
        ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream))
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
    lib = _build.load()
    n = o.shape[0]
    blk = torch.empty(n, dtype=torch.uint8, device=o.device)
    err = lib.tpurt_occluded8(
        _ptr(wide.wrow), _ptr(wide.tri_rows), _ptr(o), _ptr(d), _ptr(tmax), n,
        wide.max_rows, ctypes.c_float(t_min), _ptr(blk),
        ctypes.c_void_p(torch.cuda.current_stream(o.device).cuda_stream))
    if err:
        raise RuntimeError(f"occluded8 kernel launch failed: {_build.error_string(err)}")
    LAUNCHES["occluded8"] += 1
    return blk.bool().reshape(rays.shape)
