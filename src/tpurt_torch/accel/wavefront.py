"""tpurt's wavefront engine (``method="wave"``): every ray walks its own
escape chain over the LBVH's flat arrays, all rays in lockstep, one node a
step, a wanted leaf's triangles tested in the same step (counterpart of
``tpurt/accel/wavefront.py``, which reaches no Pallas kernel).

That is accel/traverse_ref.py's lockstep walk over ``FlatLayout``, which
these functions run: tpurt's wave gives ``traverse_ref``'s hits bit for bit,
its flags, and its k-lists, whose empty slots are (T_MAX, -1) in both.
"""

from __future__ import annotations

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.lbvh import BVH
from tpurt_torch.accel.traverse_ref import FlatLayout, closest_walk, knear_walk, occluded_walk
from tpurt_torch.core.geometry import Hit, Rays, T_MAX, Triangles


def wave_closest(rays: Rays, tris: Triangles, bvh: BVH, t_min: float = DEFAULT_T_MIN) -> Hit:
    """Closest hit per ray by (t, id); a miss is t = T_MAX, u = v = 0,
    tri = -1."""
    return closest_walk(rays, FlatLayout(tris, bvh), t_min)


def wave_occluded(rays: Rays, tris: Triangles, bvh: BVH, t_max,
                  t_min: float = DEFAULT_T_MIN) -> torch.Tensor:
    """Any hit in (t_min, t_max) per ray -> bool; a ray stops at its first
    blocking leaf."""
    return occluded_walk(rays, FlatLayout(tris, bvh), t_max, t_min)


def wave_k_ids(rays: Rays, tris: Triangles, bvh: BVH, k: int, band: float,
               t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> torch.Tensor:
    """The k nearest band hits per flat ray -> (N, k) int32 ids sorted by
    (t, id), -1 padded.  Accept: |det| > 1e-12, u, v >= -band,
    u + v <= 1 + band, t_min < t < t_max (scalar or per ray); cull bound
    min(k-th t, t_max).  The BVH's boxes carry the band."""
    return knear_walk(rays, FlatLayout(tris, bvh), k, band, t_min, t_max, empty_id=-1)[3]
