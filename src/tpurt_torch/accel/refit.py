"""Box refit of the binary LBVH after the vertices moved (counterpart of
``tpurt/accel/refit.py``): topology, Morton order, treelet cut and DFS
thread stay; node boxes are recomputed by the sparse-table range-min over
the (unchanged) sorted-leaf ranges, so they equal a fresh build's boxes bit
for bit."""

from __future__ import annotations

import dataclasses

import torch

from tpurt_torch.accel.lbvh import BVH, range_minmax_sparse
from tpurt_torch.core.geometry import Triangles


@torch.no_grad()
def refit_aabbs(bvh: BVH, tris: Triangles, update_flat: bool = True) -> BVH:
    """New node_lo/node_hi (band-inflated as build_lbvh does) and, with
    update_flat, the flat boxes the binary engines walk, scattered through
    dfs (nodes below the cut dropped).  update_flat=False leaves the flat
    boxes stale, for callers that read only node_lo/hi.  Runs without
    autograd: boxes are traversal structure."""
    v0, v1, v2 = tris.corners()
    tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
    tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
    if bvh.band > 0.0:
        pad = bvh.band * ((v1 - v0).abs() + (v2 - v0).abs()) + 1e-7
        tri_lo = tri_lo - pad
        tri_hi = tri_hi + pad

    if bvh.num_tris == 1:
        return dataclasses.replace(bvh, node_lo=tri_lo, node_hi=tri_hi,
                                   flat_lo=tri_lo.clone(), flat_hi=tri_hi.clone())

    order = bvh.tri_order.long()
    node_lo, node_hi = range_minmax_sparse(tri_lo[order], tri_hi[order],
                                           bvh.first, bvh.last)
    if not update_flat:
        return dataclasses.replace(bvh, node_lo=node_lo, node_hi=node_hi)
    m = bvh.num_flat
    live = bvh.dfs < m
    at = bvh.dfs[live].long()
    flat_lo = torch.zeros((m, 3), dtype=torch.float32, device=node_lo.device)
    flat_hi = torch.zeros_like(flat_lo)
    flat_lo[at] = node_lo[live]
    flat_hi[at] = node_hi[live]
    return dataclasses.replace(bvh, node_lo=node_lo, node_hi=node_hi,
                               flat_lo=flat_lo, flat_hi=flat_hi)
