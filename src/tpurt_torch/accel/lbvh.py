"""Karras (2012) binary-radix LBVH build (counterpart of
``tpurt/accel/lbvh.py``).

Morton codes -> stable (code, index) sort -> radix tree -> node boxes by a
sparse-table range-min over the contiguous sorted-leaf ranges -> treelet cut
and DFS thread (the ``flat_*`` arrays the binary engines walk).  Every step
is a whole-array tensor op, so the build runs on the device of the
triangles.  The output is bitwise tpurt's for the same triangles: codes are
int64 holding uint32 values, ``clz`` is computed exactly, and min/max are
exact in f32.

Not ported yet: the blocked RMQ that tpurt uses above 2^21 leaves (the 5M
configuration).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpurt_torch.accel.morton import triangle_morton_codes
from tpurt_torch.core.geometry import Triangles

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


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count of leading zeros of x as a uint32 (x int64 in [0, 2^32)).
    frexp of the float64 value is exact below 2^53: x = m * 2^e with
    m in [0.5, 1), so e is the bit length."""
    _, e = torch.frexp(x.to(torch.float64))
    return torch.where(x == 0, 32, 32 - e.to(torch.int64))


def _delta(codes: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
           n: int) -> torch.Tensor:
    """LCP length of the sorted (code, index) keys i and j; -1 when j is out
    of range.  Equal codes fall back to 32 + clz(i ^ j)."""
    valid = (j >= 0) & (j < n)
    jc = j.clamp(0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
    return torch.where(valid, d, -1)


def build_radix_tree(codes: torch.Tensor):
    """Vectorized Karras 2012 over sorted codes (N,): returns (left, right,
    parent, first, last) as int32, leaf ids offset by N-1."""
    n = codes.shape[0]
    i = torch.arange(n - 1, device=codes.device, dtype=torch.int64)

    d_raw = _delta(codes, i, i + 1, n) - _delta(codes, i, i - 1, n)
    d = torch.where(d_raw >= 0, 1, -1)
    delta_min = _delta(codes, i, i - d, n)

    # Largest l >= 1 with delta(i, i + l*d) > delta_min (monotone predicate),
    # by a fixed 31-step binary search.
    l = torch.zeros_like(i)
    for b in range(31):
        cand = l + (1 << (30 - b))
        l = torch.where(_delta(codes, i, i + cand * d, n) > delta_min, cand, l)
    j = i + l * d
    delta_node = _delta(codes, i, j, n)

    # Largest s in [0, l-1] with delta(i, i + s*d) > delta_node.
    s = torch.zeros_like(i)
    for b in range(31):
        cand = s + (1 << (30 - b))
        ok = (cand <= l - 1) & (_delta(codes, i, i + cand * d, n) > delta_node)
        s = torch.where(ok, cand, s)
    gamma = i + s * d + torch.clamp_max(d, 0)

    lo_ij = torch.minimum(i, j)
    hi_ij = torch.maximum(i, j)
    left = torch.where(lo_ij == gamma, n - 1 + gamma, gamma)
    right = torch.where(hi_ij == gamma + 1, n - 1 + gamma + 1, gamma + 1)

    parent = torch.full((2 * n - 1,), -1, dtype=torch.int64, device=codes.device)
    parent[left] = i
    parent[right] = i
    leaves = torch.arange(n, device=codes.device, dtype=torch.int64)
    first = torch.cat([lo_ij, leaves])
    last = torch.cat([hi_ij, leaves])
    return tuple(x.to(torch.int32) for x in (left, right, parent, first, last))


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
    kq = 31 - _clz32(length)  # floor(log2(len)), exact
    m = torch.minimum(flat[kq * n + f], flat[kq * n + f + length - (1 << kq)])
    return m[:, 0:3].contiguous(), (-m[:, 3:6]).contiguous()


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


def build_lbvh(tris: Triangles, leaf_size: int = 8, band: float = 0.0) -> BVH:
    """Morton sort -> radix tree -> node boxes -> DFS thread over the
    treelet cut at leaf_size triangles.

    band > 0 inflates the triangle boxes so the soft path's extended
    barycentric-band hits are still found by traversal."""
    n = tris.num_tris
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

    codes, order = torch.sort(triangle_morton_codes(tris), stable=True)
    left, right, parent, first, last = build_radix_tree(codes)
    node_lo, node_hi = range_minmax_sparse(tri_lo[order], tri_hi[order],
                                           first, last)
    dfs, esc, live, is_eff_leaf = _thread_dfs(parent, first, last, leaf_size)
    m = 2 * n - 1
    at = dfs[live].long()  # tpurt's scatter with mode="drop" of dead nodes

    def scatter(fill, src):
        out = torch.full((m,) + tuple(src.shape[1:]), fill, dtype=src.dtype,
                         device=dev)
        out[at] = src[live]
        return out

    return BVH(left=left, right=right, parent=parent, first=first, last=last,
               node_lo=node_lo, node_hi=node_hi, codes=codes,
               tri_order=order.to(torch.int32),
               flat_lo=scatter(0.0, node_lo), flat_hi=scatter(0.0, node_hi),
               flat_escape=scatter(-1, esc), flat_is_leaf=scatter(False, is_eff_leaf),
               flat_first=scatter(0, first),
               flat_count=scatter(0, torch.where(is_eff_leaf, last - first + 1, 0)),
               dfs=dfs, leaf_size=leaf_size, band=band)
