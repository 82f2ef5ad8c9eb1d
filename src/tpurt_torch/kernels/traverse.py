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
packet wants to; the kernels and twins walk each ray on its own escape
chain.  The selections do not depend on visit order, so per-ray walks give
tpurt's hits wherever a ray's own slab test is conservative; the exceptions
are inherited (ROADMAP queue 3): P1, a direction component in [-1e-30, 0)
fails every slab test, and P3, band hits outside the band-inflated box.

The twins are accel/traverse_ref.py's lockstep walks reading the packed
rows: the kernel's visit order and leaf-slot order, so the two agree bit
for bit when the kernel is built without FMA contraction.  Given a
``stats`` dict, a twin counts its walk (traverse8.walk_counts reads it).
"""

from __future__ import annotations

import ctypes

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.packet import LEAF_CAP, PackedBVH
from tpurt_torch.accel.traverse_ref import (
    _tmax_flat, closest_walk, knear_walk, occluded_walk)
from tpurt_torch.core.geometry import Hit, Rays, T_MAX
from tpurt_torch.kernels import _build

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"closest_bin": 0, "occluded_bin": 0, "knear_bin": 0}
# Largest k of the k-nearest kernel (its longest compile-time list).
KMAX = 16


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


# ---------------------------------------------------------------------------
# Plain-torch twins
# ---------------------------------------------------------------------------
def traverse_packed_ref(rays: Rays, packed: PackedBVH, t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> Hit:
    """Plain-torch twin of closest_bin; same returns as traverse_packed."""
    return closest_walk(rays, PackedLayout(packed), t_min, stats)


def occluded_packed_ref(rays: Rays, packed: PackedBVH, t_max,
                        t_min: float = DEFAULT_T_MIN,
                        stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of occluded_bin; same returns as occluded_packed."""
    return occluded_walk(rays, PackedLayout(packed), t_max, t_min, stats)


def k_nearest_ids_packed_ref(rays: Rays, packed: PackedBVH, k: int, band: float,
                             t_min: float = DEFAULT_T_MIN, t_max=T_MAX,
                             stats: dict | None = None) -> torch.Tensor:
    """Plain-torch twin of knear_bin; same returns as k_nearest_ids_packed."""
    return knear_walk(rays, PackedLayout(packed), k, band, t_min, t_max, stats)[3]


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


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
    lib = _build.load()
    n = o.shape[0]
    f32 = dict(dtype=torch.float32, device=o.device)
    t, u, v = (torch.empty(n, **f32) for _ in range(3))
    tri = torch.empty(n, dtype=torch.int32, device=o.device)
    _raise_on(lib.tpurt_closest_bin(
        *_packed_args(packed), _ptr(o), _ptr(d), n, ctypes.c_float(t_min),
        _ptr(t), _ptr(u), _ptr(v), _ptr(tri), _stream(o.device)), "closest_bin")
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
    lib = _build.load()
    n = o.shape[0]
    blk = torch.empty(n, dtype=torch.uint8, device=o.device)
    _raise_on(lib.tpurt_occluded_bin(
        *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
        ctypes.c_float(t_min), _ptr(blk), _stream(o.device)), "occluded_bin")
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
    _raise_on(lib.tpurt_knear_bin(
        *_packed_args(packed), _ptr(o), _ptr(d), _ptr(tmax), n,
        ctypes.c_float(t_min), k, ctypes.c_float(-band), ctypes.c_float(1.0 + band),
        _ptr(ids), _stream(o.device)), "knear_bin")
    LAUNCHES["knear_bin"] += 1
    return ids
