"""Binary-BVH closest-hit, any-hit and k-nearest traversal over the packed
layout (counterpart of ``tpurt/kernels/traverse.py``).

``traverse_packed``, ``occluded_packed`` and ``k_nearest_ids_packed`` launch
the hand-written CUDA kernels in ``csrc/traverse.cu`` (``closest_bin``,
``occluded_bin``, ``knear_bin``) for CUDA tensors and run their plain-torch
twins, ``traverse_packed_ref``, ``occluded_packed_ref`` and
``k_nearest_ids_packed_ref``, for CPU tensors.  There is no other route: a
CUDA tensor either reaches its kernel or the call raises.  There is no VMEM
budget either: tpurt's _plan and its packet-engine fallback are TPU
mechanisms, and any packed tree that fits the card's memory is walked.

Semantics are tpurt's (accel/traverse_ref.py lists them).  tpurt walks
(sub, 128) ray packets with one cursor, descending where any ray of the
packet wants to; the kernels and twins walk each ray on its own.  The
selections do not depend on visit order, so per-ray walks give tpurt's hits
wherever a ray's own slab test is conservative; the exceptions are
inherited (ROADMAP queue 3): P1, a direction component in [-1e-30, 0) fails
every slab test, P3, band hits outside the band-inflated box, and P6, the
closest hit's order dependence under the smooth inverse.

The twins read the packed rows in the kernels' visit order and leaf-slot
order, so the two agree bit for bit when the kernels are built without FMA
contraction.  knear_bin's is accel/traverse_ref.py's lockstep escape walk;
closest_bin's and occluded_bin's is near_walk below, the kernels' near-first
walk with its short stack (BIN_STACK entries, one a level: a deeper tree
raises).  Given a ``stats`` dict, a twin counts its walk
(traverse8.walk_counts reads it).
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.packet import LEAF_CAP, PackedBVH, tree_depth
from tpurt_torch.accel.traverse_ref import (
    Best, _slab, _tmax_flat, blocks, knear_walk, mt9, safe_inv)
from tpurt_torch.core.geometry import Hit, Rays, T_MAX
from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"closest_bin": 0, "occluded_bin": 0, "knear_bin": 0}
# Largest k of the k-nearest kernel (its longest compile-time list).
KMAX = 16
# Entries of the near-first walks' stack (csrc/traverse.cu kBinStack): one a
# level, so a tree up to this deep fits.
BIN_STACK = 64
# A walk position that ends the walk (kWalkEnd).
_END = -(2**31)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PackedLayout:
    """The packed rows as accel/traverse_ref.py's walks read them."""

    def __init__(self, packed: PackedBVH):
        self.box = packed.node_f32[:, :6]
        self.escape = packed.node_i32[:, 0].long()
        self.is_leaf = packed.node_i32[:, 3] > 0
        self.leaf_row = packed.node_i32[:, 1].long()
        self.rows = packed.tri_rows[:, :LEAF_CAP * 9].unflatten(1, (LEAF_CAP, 9))
        self.ids = packed.tri_ids

    def leaf(self, node: torch.Tensor):
        r = self.leaf_row[node]
        tid = self.ids[r]
        return self.rows[r], tid, tid >= 0


def _check_depth(packed: PackedBVH) -> None:
    """Raise when the tree is deeper than the near-first walks' stack
    (closest_bin's and occluded_bin's): a push past its end would drop a
    subtree silently.  depth -1 means the layout was packed elsewhere:
    compute it."""
    depth = packed.depth if packed.depth >= 0 else tree_depth(packed.node_i32)
    if depth > BIN_STACK:
        raise RuntimeError(
            f"the packed BVH is {depth} levels deep, more than the near-first "
            f"walks' stack holds ({BIN_STACK})")


# ---------------------------------------------------------------------------
# Plain-torch twins
# ---------------------------------------------------------------------------
def near_walk(o, d, packed: PackedBVH, t_min: float, bound: torch.Tensor, act: torch.Tensor,
              on_leaf, stats: dict | None = None) -> None:
    """closest_bin's and occluded_bin's near-first walk in lockstep, over
    rays `act` (indices into the flat o, d): the root's box is tested; from
    an internal node n whose box passed, both children (n + 1 and
    escape[n + 1]) are tested against [t_min, bound], the walk goes on into
    the nearer passing one (the smaller t_near, the left on a tie) and
    pushes the other with its t_near, or goes on into the only passing one,
    or pops; a passing leaf is tested when reached, then the stack is
    popped.  A pop drops entries with t_near > bound.  Positions are node
    indices for internal nodes and ~leaf_row for leaves; the stack holds
    BIN_STACK entries, clamped at the last as in the kernels.

    bound: every ray's cull bound (N,), read at each test and pop: the best
    hit's t, which on_leaf tightens, or a fixed t_max.  on_leaf(sel, tri,
    tid): rays `sel` test their leaves' (A, 8, 9) triangles with ids (A, 8)
    and return the (A,) mask of rays whose walk ends there (or None) and
    the rows to count.  stats counts slab tests as visits (the root's and
    two a descent) and what on_leaf returns as rows, as the kernels' bounds
    read them."""
    _check_depth(packed)
    lay = PackedLayout(packed)
    n, dev = o.shape[0], o.device
    inv = safe_inv(d)
    tmin = torch.tensor(t_min, dtype=torch.float32, device=dev)
    stack = torch.zeros((n, BIN_STACK), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((n, BIN_STACK), dtype=torch.float32, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    pos = torch.full((n,), _END, dtype=torch.int64, device=dev)
    if stats is not None and "visits" not in stats:
        stats.update(visits=0, rows=torch.zeros((), dtype=torch.int64, device=dev),
                     seen_nodes=torch.zeros(lay.box.shape[0], dtype=torch.bool, device=dev),
                     seen_rows=torch.zeros(lay.rows.shape[0], dtype=torch.bool, device=dev))

    def tested(nodes):
        if stats is not None:
            stats["visits"] += nodes.numel()
            stats["seen_nodes"][nodes] = True

    def position(node):
        return torch.where(lay.is_leaf[node], ~lay.leaf_row[node], node)

    def pop(sel):
        pos[sel] = _END
        while sel.numel():
            sel = sel[sp[sel] > 0]
            sp[sel] -= 1
            top = torch.clamp_max(sp[sel], BIN_STACK - 1)
            keep = ~(stack_t[sel, top] > bound[sel])
            pos[sel[keep]] = stack[sel, top][keep]
            sel = sel[~keep]

    root = torch.zeros_like(act)
    ok, _ = _slab(o[act], inv[act], lay.box[root], tmin, bound[act])
    tested(root)
    pos[act[ok]] = position(root[ok])
    act = act[ok]
    while act.numel():
        p = pos[act]
        inner, leaf = act[p >= 0], act[p < 0]
        if inner.numel():
            left = pos[inner] + 1
            right = lay.escape[left]
            up = bound[inner]
            pl, tl = _slab(o[inner], inv[inner], lay.box[left], tmin, up)
            pr, tr = _slab(o[inner], inv[inner], lay.box[right], tmin, up)
            tested(torch.cat([left, right]))
            cl, cr = position(left), position(right)
            both, left_first = pl & pr, tl <= tr
            # a ray that pushes nothing writes its own slot back: no host sync
            top = torch.clamp_max(sp[inner], BIN_STACK - 1)
            stack[inner, top] = torch.where(both, torch.where(left_first, cr, cl),
                                            stack[inner, top])
            stack_t[inner, top] = torch.where(both, torch.where(left_first, tr, tl),
                                              stack_t[inner, top])
            sp[inner] += both
            pos[inner] = torch.where(both, torch.where(left_first, cl, cr),
                                     torch.where(pl, cl, cr))
            dead = inner[~(pl | pr)]
        else:
            dead = inner
        if leaf.numel():
            rows = ~pos[leaf]
            ended, counted = on_leaf(leaf, lay.rows[rows], lay.ids[rows])
            if stats is not None:
                stats["rows"] += counted
                stats["seen_rows"][rows] = True
            if ended is not None:
                pos[leaf[ended]] = _END
                leaf = leaf[~ended]
        pop(torch.cat([dead, leaf]))
        act = act[pos[act] != _END]


def closest_near_walk(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN,
                      stats: dict | None = None) -> Hit:
    """closest_bin's walk (near_walk, its bound the best hit, every ray
    walking): a passing leaf's 8 slots are tested and the best hit by
    (t, id) kept; stats counts leaves as rows."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    n, dev = o.shape[0], o.device
    best = Best(n, dev)

    def on_leaf(sel, tri, tid):
        best.take(o, d, sel, tri, tid, tid >= 0, t_min)
        return None, sel.numel()

    near_walk(o, d, packed, t_min, best.t, torch.arange(n, device=dev), on_leaf, stats)
    return best.hit(rays.shape)


def traverse_packed_ref(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> Hit:
    """Plain-torch twin of closest_bin (closest_near_walk); same returns as
    traverse_packed."""
    return closest_near_walk(rays, packed, t_min, stats)


def occluded_packed_ref(rays: Rays, packed: PackedBVH, t_max,
                        t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of occluded_bin; same returns as occluded_packed.
    near_walk with the fixed bound t_max over the rays with t_max > t_min
    (the others start dead): a leaf is tested as two half rows, and the
    walk ends at the first half row that blocks.  stats counts half rows as
    rows, as the kernel tests them: one where the first half blocks, else
    two."""
    o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
    tmax = _tmax_flat(rays, t_max)
    blocked = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)

    def on_leaf(sel, tri, tid):
        t, u, v, det = mt9(o[sel], d[sel], tri)
        half = blocks(t, u, v, det, tid, t_min, tmax[sel, None]).unflatten(1, (2, 4)).any(-1)
        hit = half.any(dim=1)
        blocked[sel[hit]] = True
        return hit, 2 * sel.numel() - half[:, 0].sum()

    near_walk(o, d, packed, t_min, tmax, torch.nonzero(tmax > t_min)[:, 0], on_leaf, stats)
    return blocked.reshape(rays.shape)


def k_nearest_ids_packed_ref(rays: Rays, packed: PackedBVH, k: int, band: float,
                             t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
                             stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of knear_bin; same returns as k_nearest_ids_packed."""
    return knear_walk(rays, PackedLayout(packed), k, band, t_min, t_max, stats)[3]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check_inputs(rays: Rays, packed: PackedBVH):
    """Raise on anything the kernels do not take; returns flat (o, d)."""
    o, d = rays.o, rays.d
    if o.shape != d.shape or o.shape[-1:] != (3,):
        raise ValueError(f"rays.o {tuple(o.shape)} / rays.d {tuple(d.shape)}")
    dev = o.device
    for name, x, dt, width in (
            ("rays.o", o, torch.float32, 3), ("rays.d", d, torch.float32, 3),
            ("packed.node_f32", packed.node_f32, torch.float32, 8),
            ("packed.node_i32", packed.node_i32, torch.int32, 4),
            ("packed.tri_rows", packed.tri_rows, torch.float32, 128),
            ("packed.tri_ids", packed.tri_ids, torch.int32, LEAF_CAP)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays on {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.shape[-1] != width:
            raise ValueError(f"{name} must be (*, {width}), got {tuple(x.shape)}")
        if x.data_ptr() % 16:  # the kernels read node rows as float4 / int4
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if packed.node_f32.shape[0] != packed.node_i32.shape[0]:
        raise ValueError("packed.node_f32 and packed.node_i32 differ in length")
    if packed.tri_rows.shape[0] != packed.tri_ids.shape[0]:
        raise ValueError("packed.tri_rows and packed.tri_ids differ in length")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return o.reshape(-1, 3), d.reshape(-1, 3)


def _packed_args(packed: PackedBVH):
    return (_ptr(packed.node_f32), _ptr(packed.node_i32), _ptr(packed.tri_rows),
            _ptr(packed.tri_ids))


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {_build.error_string(err)}")


def traverse_packed(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN) -> Hit:
    """Closest hit per ray over the packed binary BVH: a Hit (t = T_MAX,
    u = v = 0, tri = -1 on a miss), ties to the lower triangle id."""
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return traverse_packed_ref(rays, packed, t_min)
    _check_depth(packed)
    lib = _build.load()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty(n, **f32) for _ in range(3))
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_closest_bin(
            *_packed_args(packed), _ptr(o), _ptr(d), n, ctypes.c_float(t_min),
            _ptr(t), _ptr(u), _ptr(v), _ptr(tri), _stream(o.device))
    _raise_on(err, "closest_bin")
    LAUNCHES["closest_bin"] += 1
    shape = rays.shape
    return Hit(t=t.reshape(shape), u=u.reshape(shape), v=v.reshape(shape),
               tri=tri.reshape(shape))


def occluded_packed(rays: Rays, packed: PackedBVH, t_max,
                    t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Any hit in (t_min, t_max) per ray -> bool (...).  t_max is a scalar
    or per-ray; rays with t_max <= t_min start dead."""
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return occluded_packed_ref(rays, packed, t_max, t_min)
    tmax = _tmax_flat(rays, t_max)
    _check_depth(packed)
    lib = _build.load()
    n = o.shape[0]
    blk = torch.empty(n, dtype=torch.uint8, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_occluded_bin(
            *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
            ctypes.c_float(t_min), _ptr(blk), _stream(o.device))
    _raise_on(err, "occluded_bin")
    LAUNCHES["occluded_bin"] += 1
    return blk.bool().reshape(rays.shape)


def k_nearest_ids_packed(rays: Rays, packed: PackedBVH, k: int, band: float,
                         t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> torch.Tensor:
    """The k nearest band hits per flat ray -> (N, k) int32 triangle ids
    sorted by (t, id), -1 padded.  Accept: |det| > 1e-12, u, v >= -band,
    u + v <= 1 + band, t_min < t < t_max (scalar or per ray; t_max <= t_min
    starts the ray dead).  Node boxes are culled against min(k-th t,
    t_max).  1 <= k <= KMAX."""
    if not 1 <= k <= KMAX:
        raise ValueError(f"k = {k} outside [1, {KMAX}]")
    o, d = _check_inputs(rays, packed)
    if o.device.type == "cpu":
        return k_nearest_ids_packed_ref(rays, packed, k, band, t_min, t_max)
    tmax = _tmax_flat(rays, t_max)
    _build.check_aligned(*(x.data_ptr() for x in (packed.node_f32, packed.node_i32,
                                                    packed.tri_rows, packed.tri_ids)))
    lib = _build.load()
    n = o.shape[0]
    ids = torch.empty((n, k), dtype=torch.int32, device=o.device)
    with _build.on_device(o):
        err = lib.tpurt_knear_bin(
            *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
            ctypes.c_float(t_min), k, ctypes.c_float(-band), ctypes.c_float(1.0 + band),
            _ptr(ids), _stream(o.device))
    _raise_on(err, "knear_bin")
    LAUNCHES["knear_bin"] += 1
    return ids
