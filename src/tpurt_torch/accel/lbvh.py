"""Karras (2012) binary-radix LBVH build (counterpart of
``tpurt/accel/lbvh.py``).

Morton codes -> stable (code, index) sort -> radix tree -> node boxes by a
sparse-table range-min over the contiguous sorted-leaf ranges -> treelet cut
and DFS thread (the ``flat_*`` arrays the binary engines walk).  The build
runs on the device of the triangles: the Morton codes and the radix tree go
through ``kernels/treebuild.py`` (the CUDA kernels on the card, their
plain-torch twins on the CPU), the sort is torch's stable sort, and the
rest are whole-array tensor ops.  The output is bitwise tpurt's for the
same triangles: codes are int64 holding uint32 values, ``clz`` is computed
exactly, and min/max are exact in f32.

Not ported, by decision: tpurt's blocked RMQ above 2^21 leaves, which keeps
the sparse table within a TPU's memory.  The flat table here is 23 levels x
N x 6 f32 at 5M leaves, which the card holds, and min is exact, so the
boxes are bitwise either way.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpurt_torch.accel.morton import triangle_morton_codes
from tpurt_torch.accel.sort_ref import sort_pairs
from tpurt_torch.core.geometry import Triangles
from tpurt_torch.kernels.treebuild import clz32, radix_tree
from tpurt_torch.obs.trace import trace_span

_BIG = 3.0e38


@dataclass
class BVH:
    """LBVH over N triangles.  Node ids: internal 0..N-2, leaf k is node
    (N-1)+k.  first/last are each node's inclusive range of Morton-sorted
    leaves; node_lo/hi its box; codes (int64 holding uint32) are the sorted
    Morton codes and tri_order maps sorted position -> triangle id.

    The flat arrays (M = 2N-1 rows, the live prefix meaningful, the rest
    zeros with escape -1) are the treelet cut in DFS order: a live node's
    subtree is entered at its index + 1 and skipped through flat_escape
    (-1 ends the walk); a leaf covers flat_count Morton-sorted triangles
    from flat_first.  dfs maps a raw node id to its flat index (M for nodes
    below the cut).  None when the BVH came from elsewhere without them."""

    left: torch.Tensor  # (N-1,) i32
    right: torch.Tensor  # (N-1,) i32
    parent: torch.Tensor  # (2N-1,) i32, -1 for the root
    first: torch.Tensor  # (2N-1,) i32
    last: torch.Tensor  # (2N-1,) i32
    node_lo: torch.Tensor  # (2N-1, 3) f32
    node_hi: torch.Tensor  # (2N-1, 3) f32
    codes: torch.Tensor  # (N,) i64
    tri_order: torch.Tensor  # (N,) i32
    flat_lo: torch.Tensor | None = None  # (M, 3) f32
    flat_hi: torch.Tensor | None = None  # (M, 3) f32
    flat_escape: torch.Tensor | None = None  # (M,) i32
    flat_is_leaf: torch.Tensor | None = None  # (M,) bool
    flat_first: torch.Tensor | None = None  # (M,) i32
    flat_count: torch.Tensor | None = None  # (M,) i32
    dfs: torch.Tensor | None = None  # (2N-1,) i32
    leaf_size: int = 8
    band: float = 0.0

    @property
    def num_tris(self) -> int:
        return self.codes.shape[0]

    @property
    def num_flat(self) -> int:
        return self.flat_escape.shape[0]


def range_minmax_sparse(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                        first: torch.Tensor, last: torch.Tensor):
    """Box of every [first, last] sorted-leaf range via a sparse-table RMQ:
    level k holds the min over windows [i, i + 2^k); any range is two
    overlapping power-of-two windows.  min is exact and idempotent, so the
    result is bitwise the bottom-up child fold."""
    n = leaf_lo.shape[0]
    box = torch.cat([leaf_lo, -leaf_hi], dim=-1)  # min-reduce both
    n_levels = 1
    while (1 << n_levels) <= n:
        n_levels += 1
    table = torch.full((n_levels, n, 6), _BIG, dtype=box.dtype, device=box.device)
    table[0] = box
    prev = box
    for k in range(1, n_levels):
        h = 1 << (k - 1)
        shifted = torch.cat(
            [prev[h:], torch.full((h, 6), _BIG, dtype=box.dtype, device=box.device)])
        prev = torch.minimum(prev, shifted)
        table[k] = prev
    flat = table.reshape(-1, 6)
    f = first.to(torch.int64)
    length = last.to(torch.int64) - f + 1
    kq = 31 - clz32(length)  # floor(log2(len)), exact
    m = torch.minimum(flat[kq * n + f], flat[kq * n + f + length - (1 << kq)])
    return m[:, 0:3].contiguous(), (-m[:, 3:6]).contiguous()


def refit_node_aabbs(left: torch.Tensor, right: torch.Tensor, leaf_lo: torch.Tensor,
                     leaf_hi: torch.Tensor, max_depth: int):
    """Node boxes by level-synchronous passes (tpurt's reference fold): every
    internal node takes the min / max of its children's boxes, all nodes at
    once, until a pass changes nothing or after max_depth passes.  leaf_lo,
    leaf_hi are in sorted order; returns (2N-1, 3) boxes, internal nodes
    first, equal to range_minmax_sparse's bit for bit where it converged."""
    n = leaf_lo.shape[0]
    big = 3.0e38
    lo = torch.cat([leaf_lo.new_full((n - 1, 3), big), leaf_lo])
    hi = torch.cat([leaf_hi.new_full((n - 1, 3), -big), leaf_hi])
    left, right = left.long(), right.long()
    for _ in range(max_depth):
        new_lo = torch.cat([torch.minimum(lo[left], lo[right]), leaf_lo])
        new_hi = torch.cat([torch.maximum(hi[left], hi[right]), leaf_hi])
        changed = bool((new_lo != lo).any() or (new_hi != hi).any())
        lo, hi = new_lo, new_hi
        if not changed:
            break
    return lo, hi


def _thread_dfs(parent: torch.Tensor, first: torch.Tensor, last: torch.Tensor,
                leaf_size: int):
    """Treelet cut, DFS numbering and escape links in closed form (tpurt's
    _thread_dfs): a node is live when its parent is not cuttable (subtree
    counts grow towards the root); a live node's preorder index is
    Fc[first - 1] + Fc[first] - 1 - pos, with Fc[v] the live nodes starting
    at or left of v and pos its rank in the (first, last) order; its escape
    is Fc[last], or -1 past the last live node.  Returns (dfs, escape, live,
    is_eff_leaf), dfs = M for dead nodes."""
    n = (first.shape[0] + 1) // 2
    m = 2 * n - 1
    first, last = first.long(), last.long()
    cuttable = last - first + 1 <= leaf_size
    live = (parent < 0) | ~cuttable[parent.long().clamp_min(0)]
    is_eff_leaf = live & cuttable
    n_live = live.sum()
    f2 = torch.where(live, first, n)  # dead nodes bucket past every live one
    fc = torch.cumsum(torch.bincount(f2, minlength=n + 1)[:n], 0)
    # rank in the lexicographic (f2, last) order; live keys are distinct
    order = torch.sort(f2 * (n + 1) + last, stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(m, device=order.device)
    fc_lo = torch.where(first > 0, fc[(first - 1).clamp_min(0)], 0)
    dfs = torch.where(live, fc_lo + fc[first] - 1 - pos, m)
    esc = fc[last]
    esc = torch.where(esc < n_live, esc, -1)
    return dfs.to(torch.int32), esc.to(torch.int32), live, is_eff_leaf


def build_lbvh(tris: Triangles, leaf_size: int = 8, band: float = 0.0,
               sort_backend: str = "xla") -> BVH:
    """Morton sort -> radix tree -> node boxes -> DFS thread over the
    treelet cut at leaf_size triangles.  Each stage runs in a named span
    (``lbvh.*``), so a torch.profiler trace splits the build by stage.

    band > 0 inflates the triangle boxes so the soft path's extended
    barycentric-band hits are still found by traversal.  sort_backend:
    sort_pairs' route for the Morton sort ("xla": torch.sort; "ref": the
    radix sort, the same tree)."""
    n = tris.num_tris
    with trace_span("lbvh.boxes"):
        v0, v1, v2 = tris.corners()
        tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
        tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
        if band > 0.0:
            pad = band * ((v1 - v0).abs() + (v2 - v0).abs()) + 1e-7
            tri_lo = tri_lo - pad
            tri_hi = tri_hi + pad
    dev = tris.device

    if n == 1:  # single-triangle scene: one flat leaf
        z = torch.zeros((1,), dtype=torch.int32, device=dev)
        e = torch.zeros((0,), dtype=torch.int32, device=dev)
        return BVH(left=e, right=e.clone(),
                   parent=torch.full((1,), -1, dtype=torch.int32, device=dev),
                   first=z, last=z.clone(), node_lo=tri_lo, node_hi=tri_hi,
                   codes=torch.zeros((1,), dtype=torch.int64, device=dev),
                   tri_order=z.clone(), flat_lo=tri_lo.clone(),
                   flat_hi=tri_hi.clone(), flat_escape=z - 1,
                   flat_is_leaf=torch.ones((1,), dtype=torch.bool, device=dev),
                   flat_first=z.clone(), flat_count=z + 1, dfs=z.clone(),
                   leaf_size=leaf_size, band=band)

    raw = triangle_morton_codes(tris)
    with trace_span("lbvh.sort"):
        codes, tri_order = sort_pairs(raw, torch.arange(n, dtype=torch.int32, device=dev),
                                      backend=sort_backend)
        order = tri_order.long()
    with trace_span("lbvh.radix"):
        left, right, parent, first, last = radix_tree(codes)
    with trace_span("lbvh.rmq"):
        node_lo, node_hi = range_minmax_sparse(tri_lo[order], tri_hi[order],
                                               first, last)
    with trace_span("lbvh.thread_dfs"):
        dfs, esc, live, is_eff_leaf = _thread_dfs(parent, first, last, leaf_size)
    with trace_span("lbvh.flat_scatter"):
        m = 2 * n - 1
        at = dfs[live].long()  # tpurt's scatter with mode="drop" of dead nodes

        def scatter(fill, src):
            out = torch.full((m,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                             device=dev)
            out[at] = src[live]
            return out

        flat = dict(flat_lo=scatter(0.0, node_lo), flat_hi=scatter(0.0, node_hi),
                    flat_escape=scatter(-1, esc),
                    flat_is_leaf=scatter(False, is_eff_leaf),
                    flat_first=scatter(0, first),
                    flat_count=scatter(0, torch.where(is_eff_leaf, last - first + 1, 0)))
    return BVH(left=left, right=right, parent=parent, first=first, last=last,
               node_lo=node_lo, node_hi=node_hi, codes=codes,
               tri_order=tri_order, dfs=dfs, leaf_size=leaf_size,
               band=band, **flat)
