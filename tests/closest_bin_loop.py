"""csrc/traverse.cu's closest_bin_walk rendered one ray at a time in numpy
float32, statement for statement: the root's box tested, then at each
internal node both children (n + 1 and escape[n + 1]) tested against
[t_min, t_b], the nearer passing child entered (the left on a tie) and the
farther pushed with its t_near, pops culled by t_near > t_b, while-while
descents and leaves tested as two half rows.  Shared by the tests that hold
the twin's outputs (test_torch_closest_design.py) and its walk counts
(test_torch_traverse_bin.py) to the kernel's loop; not a test module.
"""

import numpy as np
import torch

from tests.test_torch_traverse8 import _mt_numpy_det
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


def closest_bin_kernel_loop(packed, o, d):
    """closest_bin_walk over every ray of (o, d): returns (t, u, v, id), the
    walk counts (slab tests as visits, leaves as rows) and the deepest
    stack."""
    nf, ni = packed.node_f32.numpy(), packed.node_i32.numpy()
    rows = packed.tri_rows.numpy()[:, :72].reshape(-1, 8, 9)
    ids = packed.tri_ids.numpy()
    inv_all = safe_inv(torch.from_numpy(d)).numpy()
    n = o.shape[0]
    out = [np.zeros(n, f32) for _ in range(3)] + [np.full(n, -1, np.int32)]
    counts = {"visits": 0, "rows": 0}
    seen_n, seen_r, deepest = set(), set(), 0

    def position(node):
        return ~int(ni[node, 1]) if ni[node, 3] > 0 else int(node)

    for i in range(n):
        b, stack, inv = Best(), [], inv_all[i]

        def test(node):
            counts["visits"] += 1
            seen_n.add(int(node))
            return slab(nf[node, 0:3], nf[node, 3:6], o[i], inv, b.t)

        def pop():
            while stack:
                p, tn = stack.pop()
                if not tn > b.t:
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
            if pos == END:
                break
            row = ~pos
            counts["rows"] += 1
            seen_r.add(row)
            for h in (0, 1):
                b.half(rows[row, 4 * h:4 * h + 4], ids[row, 4 * h:4 * h + 4], o[i], d[i],
                       lambda j: None)
            pos = pop()
        out[0][i], out[1][i], out[2][i], out[3][i] = b.t, b.u, b.v, b.id
    counts.update(distinct_nodes=len(seen_n), distinct_rows=len(seen_r))
    return out, counts, deepest
