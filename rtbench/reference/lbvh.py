"""A plain-torch bounding volume hierarchy and its walks: the reference's
own tree, built from the frozen scene arrays, independent of the port.

The tree is Karras's LBVH with one triangle a leaf: Morton codes of the
triangles' box centres (10 bits an axis), a stable sort, the radix tree
over the sorted codes (each made unique by its sorted position), and boxes
merged bottom-up.  Internal nodes are 0 .. N-2 (the root is 0), leaf k is
node N-1+k and holds the k-th triangle in sorted order.  Boxes are padded
outward by a little more than a rounding, so that no walk loses a hit to
the slab test's rounding.

``walk`` runs every ray at once in lockstep, a stack a ray, nearer child
on top, for the nearest Möller–Trumbore hit in (t_min, t_max) or, with
any_hit, for any hit there.  It also counts the box tests
(two a visited internal node) and triangle tests (one a visited leaf) it
made, which ``metrics/walk_roofline_pct.py`` turns into the work a frame
needs.  The arithmetic runs in the dtype of the rays handed in (float32;
bfloat16 for the control), the topology is the float32 build's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

STACK = 128
CHECK_EVERY = 16
MAX_LEAVES = 1 << 23  # the sorted position takes 23 bits of a unique key
DET_EPS = 1e-12


@dataclass
class Tree:
    left: torch.Tensor    # (N-1,) int64 child node ids
    right: torch.Tensor
    lo: torch.Tensor      # (2N-1, 3) f32 node boxes
    hi: torch.Tensor
    order: torch.Tensor   # (N,) int64: leaf k holds triangle order[k]

    @property
    def num_leaves(self) -> int:
        return int(self.order.shape[0])

    def to(self, dtype) -> "Tree":
        return Tree(self.left, self.right, self.lo.to(dtype), self.hi.to(dtype), self.order)


def _spread10(v: torch.Tensor) -> torch.Tensor:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton30(points: torch.Tensor) -> torch.Tensor:
    lo = points.amin(0)
    ext = torch.clamp_min(points.amax(0) - lo, 1e-30)
    q = ((points - lo) / ext * 1023.0).clamp(0, 1023).to(torch.int64)
    return (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) | _spread10(q[:, 2])


def build(tri_lo: torch.Tensor, tri_hi: torch.Tensor) -> Tree:
    """The LBVH over triangle boxes (N, 3) f32."""
    n = tri_lo.shape[0]
    if not 1 <= n < MAX_LEAVES:
        raise ValueError(f"{n} triangles: the reference tree takes 1 to {MAX_LEAVES - 1}")
    dev = tri_lo.device
    pad = 1e-6 * torch.maximum(tri_lo.abs(), tri_hi.abs()) + 1e-6
    tri_lo, tri_hi = tri_lo - pad, tri_hi + pad
    codes = morton30(0.5 * (tri_lo + tri_hi))
    codes, order = torch.sort(codes, stable=True)
    keys = (codes << 23) | torch.arange(n, device=dev)
    lo = torch.empty((2 * n - 1, 3), dtype=torch.float32, device=dev)
    hi = torch.empty_like(lo)
    lo[n - 1:], hi[n - 1:] = tri_lo[order], tri_hi[order]
    if n == 1:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return Tree(empty, empty, lo, hi, order)

    def delta(i, j):
        inside = (j >= 0) & (j < n)
        x = (keys[i] ^ keys[j.clamp(0, n - 1)]).to(torch.float64)
        return torch.where(inside, 64 - torch.frexp(x).exponent.to(torch.int64), -1)

    i = torch.arange(n - 1, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    dmin = delta(i, i - d)
    lmax = torch.full_like(i, 2)
    grow = torch.ones_like(i, dtype=torch.bool)
    for _ in range(64):
        grow = grow & (delta(i, i + lmax * d) > dmin)
        if not bool(grow.any()):
            break
        lmax = torch.where(grow, lmax * 2, lmax)
    l = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(64):
        step = t >= 1
        if not bool(step.any()):
            break
        l = torch.where(step & (delta(i, i + (l + t) * d) > dmin), l + t, l)
        t = t // 2
    j = i + l * d
    dnode = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    live = torch.ones_like(i, dtype=torch.bool)
    for _ in range(64):
        t = (t + 1) // 2
        s = torch.where(live & (delta(i, i + (s + t) * d) > dnode), s + t, s)
        live = live & (t > 1)
        if not bool(live.any()):
            break
    gamma = i + s * d + torch.clamp_max(d, 0)
    left = torch.where(torch.minimum(i, j) == gamma, gamma + n - 1, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + n, gamma + 1)

    ready = torch.zeros(2 * n - 1, dtype=torch.bool, device=dev)
    ready[n - 1:] = True
    pending = i
    while pending.numel():
        can = ready[left[pending]] & ready[right[pending]]
        p = pending[can]
        lo[p] = torch.minimum(lo[left[p]], lo[right[p]])
        hi[p] = torch.maximum(hi[left[p]], hi[right[p]])
        ready[p] = True
        pending = pending[~can]
    return Tree(left, right, lo, hi, order)


def tri_boxes(v0, v1, v2):
    return torch.minimum(torch.minimum(v0, v1), v2), torch.maximum(torch.maximum(v0, v1), v2)


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def moller_trumbore(o, d, v0, e1, e2):
    """(t, inside): the ray parameter and whether (u, v) lies in the
    triangle with a determinant away from 0."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = det.abs() > DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = _dot(tv, p) * inv
    q = _cross(tv, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    return t, ok & (u >= 0) & (v >= 0) & (u + v <= 1)


@dataclass
class WalkResult:
    t: torch.Tensor        # nearest hit's t (closest) or t_max (any_hit)
    tri: torch.Tensor      # int64 triangle id, -1 for none (closest)
    blocked: torch.Tensor  # bool (any_hit)
    box_tests: torch.Tensor  # (R,) int64
    tri_tests: torch.Tensor


def walk(tree: Tree, tris: tuple, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
         t_min: float, any_hit: bool) -> WalkResult:
    """Lockstep stack walk of every ray (o, d (R, 3), t_max (R,), all of
    one dtype).  tris: (v0, e1, e2) (T, 3) in that dtype, indexed by
    triangle id."""
    v0, e1, e2 = tris
    r = o.shape[0]
    dev, dt = o.device, o.dtype
    n = tree.num_leaves
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    stack = torch.zeros((r, STACK), dtype=torch.int64, device=dev)
    enter = torch.zeros((r, STACK), dtype=dt, device=dev)
    best = t_max.clone()
    sp = (best > t_min).to(torch.int64)
    tri = torch.full((r,), -1, dtype=torch.int64, device=dev)
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    box_tests = torch.zeros(r, dtype=torch.int64, device=dev)
    tri_tests = torch.zeros(r, dtype=torch.int64, device=dev)
    deepest = torch.zeros((), dtype=torch.int64, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def slab(c):
        t0 = (tree.lo[c] - o) * inv
        t1 = (tree.hi[c] - o) * inv
        tn = torch.maximum(torch.minimum(t0, t1).amax(-1), zero)
        tf = torch.minimum(torch.maximum(t0, t1).amin(-1), best)
        return tn, tn <= tf

    it = 0
    while True:
        if it % CHECK_EVERY == 0 and not bool((sp > 0).any()):
            break
        it += 1
        active = sp > 0
        top = (sp - 1).clamp_min(0)[:, None]
        node = stack.gather(1, top)[:, 0]
        ent = enter.gather(1, top)[:, 0]
        sp = sp - active.to(torch.int64)
        live = active & (ent < best)
        leaf = node >= n - 1
        if n > 1:
            inner = live & ~leaf
            k = node.clamp_max(n - 2)
            cl, cr = tree.left[k], tree.right[k]
            tl, hl = slab(cl)
            tr, hr = slab(cr)
            hl, hr = hl & inner, hr & inner
            box_tests += 2 * inner.to(torch.int64)
            left_near = tl <= tr
            both = hl & hr
            first = torch.where(both, torch.where(left_near, cr, cl), torch.where(hl, cl, cr))
            first_t = torch.where(both, torch.where(left_near, tr, tl), torch.where(hl, tl, tr))
            second = torch.where(left_near, cl, cr)
            second_t = torch.where(left_near, tl, tr)
            at0 = sp.clamp_max(STACK - 1)[:, None]
            at1 = (sp + 1).clamp_max(STACK - 1)[:, None]
            stack.scatter_(1, at0, first[:, None])
            enter.scatter_(1, at0, first_t[:, None])
            stack.scatter_(1, at1, second[:, None])
            enter.scatter_(1, at1, second_t[:, None])
            sp = sp + hl.to(torch.int64) + hr.to(torch.int64)
            deepest = torch.maximum(deepest, sp.max())
        at_leaf = live & leaf
        tid = tree.order[(node - (n - 1)).clamp(0, n - 1)]
        t, inside = moller_trumbore(o, d, v0[tid], e1[tid], e2[tid])
        hit = at_leaf & inside & (t > t_min) & (t < best)
        tri_tests += at_leaf.to(torch.int64)
        if any_hit:
            blocked |= hit
            sp = torch.where(hit, torch.zeros_like(sp), sp)
        else:
            best = torch.where(hit, t, best)
            tri = torch.where(hit, tid, tri)
    if int(deepest) >= STACK - 1:
        raise RuntimeError(f"reference walk stack overflow ({int(deepest)} of {STACK})")
    return WalkResult(t=best, tri=tri, blocked=blocked, box_tests=box_tests,
                      tri_tests=tri_tests)
