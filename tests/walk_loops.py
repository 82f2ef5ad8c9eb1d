"""The binary near-first walks (csrc/traverse.cu closest_bin_walk,
occluded_bin_walk) and occluded8's walk (csrc/traverse8.cu occluded8_walk)
rendered one ray at a time in numpy float32, statement for statement.

The near-first walks share bin_walk, as the kernels share bin_root,
bin_descend and BinStack: the root's box tested, then at each internal node
both children (n + 1 and escape[n + 1]) tested against [t_min, bound], the
nearer passing child entered (the left on a tie) and the farther pushed with
its t_near, pops culled by t_near > bound, while-while descents.
closest_bin's bound is its best hit, and it tests a leaf as two half rows
slot by slot; occluded_bin's bound is t_max, and it ends at the first half
row that blocks.  occluded8 pushes a visit's passing internal children in
entry order and pops, its visits repeating until one passes a leaf
(while-while), then tests the passing leaves' rows in one flat loop, each
as two half rows, and ends at the first half row that blocks.  The
any-hit renderings count half rows as rows, as their twins do.

Shared by the tests that hold the twins' outputs (test_torch_closest_design.py,
test_torch_occluded_design.py) and their walk counts
(test_torch_traverse_bin.py) to the kernels' loops; not a test module.
"""

import numpy as np
import torch

from tests.test_torch_knear_design import KernelStack
from tests.test_torch_traverse8 import _mt_numpy_det
from tpurt_torch.accel.bvh8 import decode_lane_i32
from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.traverse_ref import safe_inv
from tpurt_torch.core.geometry import T_MAX

f32 = np.float32
T_MIN = f32(DEFAULT_T_MIN)
END = -(2**31)  # kWalkEnd


def slab(lo, hi, o, inv, upper):
    """The binary slab test (lo - o) * inv in numpy float32 -> (pass, t_near)."""
    with np.errstate(over="ignore", invalid="ignore"):
        t0, t1 = (lo - o) * inv, (hi - o) * inv
    tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
    near = np.maximum(np.maximum(tn[0], tn[1]), np.maximum(tn[2], T_MIN))
    far = np.minimum(np.minimum(tf[0], tf[1]), np.minimum(tf[2], upper))
    return bool(near <= far), near


class Best:
    """The kernels' best hit and their slot-by-slot `better` test."""

    def __init__(self):
        self.t, self.u, self.v, self.id, self.win = f32(T_MAX), f32(0), f32(0), -1, None

    def half(self, tri9, tid, o, d, where):
        """4 slots of a half row, tested in slot order; where(j) names the
        winning slot."""
        t, u, v, det = _mt_numpy_det(o[None], d[None], tri9)
        for j in range(4):
            better = t[j] < self.t or (t[j] == self.t and tid[j] < self.id and self.id >= 0)
            if (abs(det[j]) > f32(1e-12) and u[j] >= 0 and v[j] >= 0 and u[j] + v[j] <= 1
                    and t[j] > T_MIN and better and tid[j] >= 0):
                self.t, self.u, self.v, self.id, self.win = t[j], u[j], v[j], int(tid[j]), where(j)


def row_blocks(tri9, tid, o, d, tmax, counts) -> bool:
    """The any-hit test of a row's (or leaf's) 8 slots (tri9 (8, 9), ids
    tid (8,)) as two half rows, each counted as a row: True at the first
    half row that blocks (the second then left untested)."""
    for h in (0, 1):
        counts["rows"] += 1
        t, u, v, det = _mt_numpy_det(o[None], d[None], tri9[4 * h:4 * h + 4])
        ok = ((np.abs(det) > f32(1e-12)) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN)
              & (t < tmax) & (tid[4 * h:4 * h + 4] >= 0))
        if ok.any():
            return True
    return False


def bin_walk(nf, ni, o, inv, bound, leaf, counts, seen_n) -> int:
    """One ray's near-first walk over the packed node rows: bound() is the
    cull bound at each test and pop, leaf(row) tests a passing leaf when the
    walk reaches it and returns True where the walk ends.  Counts slab tests
    as visits.  Returns the deepest the stack got."""
    stack, deepest = [], 0

    def test(node):
        counts["visits"] += 1
        seen_n.add(int(node))
        return slab(nf[node, 0:3], nf[node, 3:6], o, inv, bound())

    def position(node):
        return ~int(ni[node, 1]) if ni[node, 3] > 0 else int(node)

    def pop():
        while stack:
            p, tn = stack.pop()
            if not tn > bound():
                return p
        return END

    ok, _ = test(0)
    pos = position(0) if ok else END
    while pos != END:
        while pos >= 0:  # descents repeat until this ray holds a leaf
            left = pos + 1
            right = int(ni[left, 0])
            (pl, tl), (pr, tr) = test(left), test(right)
            cl, cr = position(left), position(right)
            if pl and pr:
                stack.append((cr, tr) if tl <= tr else (cl, tl))
                deepest = max(deepest, len(stack))
                pos = cl if tl <= tr else cr
            else:
                pos = cl if pl else (cr if pr else pop())
        if pos == END or leaf(~pos):
            break
        pos = pop()
    return deepest


def _packed(packed, d):
    return (packed.node_f32.numpy(), packed.node_i32.numpy(),
            packed.tri_rows.numpy()[:, :72].reshape(-1, 8, 9), packed.tri_ids.numpy(),
            safe_inv(torch.from_numpy(d)).numpy())


def closest_bin_kernel_loop(packed, o, d):
    """closest_bin_walk over every ray of (o, d): returns (t, u, v, id), the
    walk counts (slab tests as visits, leaves as rows) and the deepest
    stack."""
    nf, ni, rows, ids, inv_all = _packed(packed, d)
    n = o.shape[0]
    out = [np.zeros(n, f32) for _ in range(3)] + [np.full(n, -1, np.int32)]
    counts = {"visits": 0, "rows": 0}
    seen_n, seen_r, deepest = set(), set(), 0
    for i in range(n):
        b = Best()

        def leaf(row):
            counts["rows"] += 1
            seen_r.add(row)
            for h in (0, 1):
                b.half(rows[row, 4 * h:4 * h + 4], ids[row, 4 * h:4 * h + 4], o[i], d[i],
                       lambda j: None)
            return False

        deepest = max(deepest, bin_walk(nf, ni, o[i], inv_all[i], lambda: b.t, leaf, counts,
                                        seen_n))
        out[0][i], out[1][i], out[2][i], out[3][i] = b.t, b.u, b.v, b.id
    counts.update(distinct_nodes=len(seen_n), distinct_rows=len(seen_r))
    return out, counts, deepest


def occluded_bin_kernel_loop(packed, o, d, tmax):
    """occluded_bin_walk over every ray of (o, d) with window (t_min, tmax):
    returns the flags, the walk counts (slab tests as visits, half rows as
    rows), the deepest stack and the number of rays blocked in the first
    leaf they tested.  Rays with tmax <= t_min start dead."""
    nf, ni, rows, ids, inv_all = _packed(packed, d)
    n = o.shape[0]
    flags = np.zeros(n, bool)
    counts = {"visits": 0, "rows": 0}
    seen_n, seen_r, deepest, first = set(), set(), 0, 0
    for i in range(n):
        if not tmax[i] > T_MIN:
            continue
        leaves = []

        def leaf(row):
            leaves.append(row)
            seen_r.add(row)
            flags[i] = row_blocks(rows[row], ids[row], o[i], d[i], tmax[i], counts)
            return flags[i]

        deepest = max(deepest, bin_walk(nf, ni, o[i], inv_all[i], lambda: tmax[i], leaf,
                                        counts, seen_n))
        first += bool(flags[i]) and len(leaves) == 1
    counts.update(distinct_nodes=len(seen_n), distinct_rows=len(seen_r))
    return flags, counts, deepest, first


def occluded8_kernel_loop(wide, o, d, tmax):
    """occluded8_walk over every ray of (o, d) with window (t_min, tmax):
    returns the flags, the walk counts (visits, half rows as rows), the
    deepest stack and the number of rays blocked in the first row they
    tested.  Rays with tmax <= t_min start dead."""
    nodes = wide.wrow.reshape(-1, 64)
    box = nodes[:, :48].numpy().reshape(-1, 8, 6)
    meta_all = decode_lane_i32(nodes.view(torch.int32)[:, 48:56]).numpy()
    trows = wide.tri_rows.numpy()[:, :72].reshape(-1, 8, 9)
    tids = decode_lane_i32(wide.tri_rows.view(torch.int32)[:, 72:80]).numpy()
    inv_all = safe_inv(torch.from_numpy(d)).numpy()
    n = o.shape[0]
    flags = np.zeros(n, bool)
    counts = {"visits": 0, "rows": 0}
    seen_n, seen_r, deepest, first = set(), set(), 0, 0
    for i in range(n):
        tm = tmax[i]
        if not tm > T_MIN:
            continue
        inv, oi = inv_all[i], o[i] * inv_all[i]
        st, cur, tested = KernelStack(), 0, 0
        while cur >= 0 and not flags[i]:
            leaves = []
            while cur >= 0 and not leaves:  # visits repeat until one passes a leaf
                counts["visits"] += 1
                seen_n.add(cur)
                bx = box[cur]
                with np.errstate(over="ignore", invalid="ignore"):  # empty slots: 3e38
                    t0, t1 = bx[:, :3] * inv - oi, bx[:, 3:] * inv - oi
                near = np.maximum(np.minimum(t0, t1).max(axis=1), T_MIN)
                far = np.minimum(np.maximum(t0, t1).min(axis=1), tm)
                meta = meta_all[cur]
                passing = [c for c in range(8) if near[c] <= far[c]]
                for c in passing:
                    if meta[c] >= 0:
                        st.push(int(meta[c]))
                deepest = max(deepest, st.sp)
                cur = st.pop()
                leaves = [~int(meta[c]) for c in passing if meta[c] < 0]
            # one flat loop over the passing leaves' rows, child by child
            leaf_rows = [r for nm in leaves
                         for r in range(nm >> 3, (nm >> 3) + max(0, min((nm & 7) + 1,
                                                                       wide.max_rows)))]
            for row in leaf_rows:
                tested += 1
                seen_r.add(row)
                if row_blocks(trows[row], tids[row], o[i], d[i], tm, counts):
                    flags[i] = True
                    first += tested == 1
                    break
    counts.update(distinct_nodes=len(seen_n), distinct_rows=len(seen_r))
    return flags, counts, deepest, first
