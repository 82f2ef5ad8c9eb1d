"""The packed binary-BVH layout the binary kernels walk (counterpart of the
layout half of ``tpurt/accel/packet.py``), byte for byte tpurt's:

  node_f32: (M, 8)  f32 [lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, 0, 0]
  node_i32: (M, 4)  i32 [escape (-1 ends the walk), leaf_row, 0, is_leaf]
  tri_rows: (L, 128) f32, per leaf LEAF_CAP x (v0, e1, e2), all-zero pad
            triangles (they fail every det test), lanes 72..127 zero
  tri_ids:  (L, LEAF_CAP) i32 triangle id per slot, -1 pad

Nodes are the LBVH's flat (DFS) arrays over the treelet cut and leaf rows
are numbered in DFS order: internal node n's children are n + 1 and
escape[n + 1].  make_tracer packs with the static bound
max_cut_leaves instead of the live leaf count, as tpurt does, so the arrays
carry unreachable zero rows past the live prefix.

Two engines walk this layout: the binary per-ray kernels of
kernels/traverse.py (tpurt's "pallas") and tpurt's packet engine
(traverse_packet, occluded_packet, k_nearest_ids_packet: one cursor per
1,024-ray packet), ported as kernels/packet.py, CUDA kernels on the GPU and
plain-torch twins on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpurt_torch.accel.lbvh import BVH
from tpurt_torch.core.geometry import Triangles

LEAF_CAP = 8  # triangles packed per leaf row: LEAF_CAP * 9 floats <= 128


def max_cut_leaves(num_tris: int, leaf_size: int) -> int:
    """Static upper bound on treelet-cut leaves: a cut leaf's parent subtree
    holds more than leaf_size triangles, so sibling leaf pairs cover at
    least leaf_size + 1 of them: at most 2 * ceil(N / (leaf_size + 1))."""
    return max(1, 2 * (-(-num_tris // (leaf_size + 1))))


@dataclass
class PackedBVH:
    """Traversal layout of a binary LBVH (module docstring)."""

    node_f32: torch.Tensor
    node_i32: torch.Tensor
    tri_rows: torch.Tensor
    tri_ids: torch.Tensor
    band: float = 0.0
    # levels below the root of the deepest leaf (-1: not computed); a
    # near-first walk's stack holds at most one entry a level
    depth: int = -1

    @property
    def num_nodes(self) -> int:
        return self.node_f32.shape[0]

    @property
    def num_leaves(self) -> int:
        return self.tri_rows.shape[0]


def _node_f32(bvh: BVH, n_live: int) -> torch.Tensor:
    z = torch.zeros((n_live, 2), dtype=torch.float32, device=bvh.flat_lo.device)
    return torch.cat([bvh.flat_lo[:n_live], bvh.flat_hi[:n_live], z], dim=1)


def _leaf_rows(tris: Triangles, tid: torch.Tensor) -> torch.Tensor:
    """(L, LEAF_CAP) ids -> (L, 128) rows of (v0, e1, e2), zeros at -1."""
    ok = (tid >= 0)[..., None]
    g = tid.clamp_min(0).long()
    v0, v1, v2 = tris.corners()
    tri = torch.cat([torch.where(ok, v0[g], 0.0), torch.where(ok, v1[g] - v0[g], 0.0),
                     torch.where(ok, v2[g] - v0[g], 0.0)], dim=-1)
    rows = tri.reshape(tid.shape[0], LEAF_CAP * 9)
    return torch.nn.functional.pad(rows, (0, 128 - LEAF_CAP * 9))


@torch.no_grad()
def tree_depth(node_i32: torch.Tensor) -> int:
    """The levels below the root of the deepest leaf reachable from node 0
    of a packed layout: level by level, internal node n's children are
    n + 1 and escape[n + 1].  Unreachable rows past the live tree are never
    read."""
    escape, is_leaf = node_i32[:, 0].long(), node_i32[:, 3] > 0
    level = torch.zeros(1, dtype=torch.int64, device=node_i32.device)
    depth = 0
    while True:
        inner = level[~is_leaf[level]]
        if not inner.numel():
            return depth
        level = torch.cat([inner + 1, escape[inner + 1]])
        depth += 1


@torch.no_grad()
def pack_bvh(tris: Triangles, bvh: BVH, n_leaves: int | None = None) -> PackedBVH:
    """Re-layout a built LBVH for the binary walks: the first 2 n_leaves - 1
    flat nodes (the cut tree is a full binary tree over its leaves), leaf
    rows in flat order, triangles gathered through the Morton order.

    n_leaves: the row count, at least the live leaf count (None: that
    count).  Where 2 n_leaves - 1 exceeds the 2N - 1 flat rows (a bound on
    a tiny scene) the nodes stop at 2N - 1."""
    if bvh.leaf_size > LEAF_CAP:
        raise ValueError(f"leaf_size {bvh.leaf_size} > packable {LEAF_CAP}")
    if n_leaves is None:
        n_leaves = int(bvh.flat_is_leaf.sum())
    n_live = min(2 * n_leaves - 1, bvh.num_flat)
    is_leaf = bvh.flat_is_leaf[:n_live]
    leaf_row = torch.cumsum(is_leaf.to(torch.int32), 0, dtype=torch.int32) - 1
    node_i32 = torch.stack([bvh.flat_escape[:n_live],
                            torch.where(is_leaf, leaf_row, 0),
                            torch.zeros_like(leaf_row), is_leaf.to(torch.int32)], dim=1)

    slot = torch.arange(LEAF_CAP, device=is_leaf.device)
    first = bvh.flat_first[:n_live][is_leaf]
    in_range = slot < bvh.flat_count[:n_live][is_leaf][:, None]
    si = (first[:, None] + slot).clamp(0, bvh.num_tris - 1).long()
    tid = torch.where(in_range, bvh.tri_order[si], -1)
    tri_ids = torch.full((n_leaves, LEAF_CAP), -1, dtype=torch.int32, device=tid.device)
    tri_ids[leaf_row[is_leaf].long()] = tid
    return PackedBVH(node_f32=_node_f32(bvh, n_live), node_i32=node_i32,
                     tri_rows=_leaf_rows(tris, tri_ids), tri_ids=tri_ids, band=bvh.band,
                     depth=tree_depth(node_i32))


@torch.no_grad()
def refit_packed(packed: PackedBVH, bvh: BVH, tris: Triangles) -> PackedBVH:
    """The layout after the vertices moved: node boxes from an already refit
    BVH (accel/refit.refit_aabbs), leaf rows regathered through the frozen
    tri_ids.  Shapes are unchanged."""
    return dataclasses.replace(packed, node_f32=_node_f32(bvh, packed.num_nodes),
                               tri_rows=_leaf_rows(tris, packed.tri_ids))
