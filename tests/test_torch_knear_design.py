"""The k-nearest kernels' loop structure (csrc/traverse8.cu knear8_walk,
csrc/traverse.cu knear_bin_walk) held to the plain-torch twins.

The CUDA kernels cannot run here, so their loops are rendered one ray at a
time in numpy float32, statement for statement: the while-while structure
(node visits repeat until a lane has leaf rows to test), knear8's flat loop
over all rows of a visit's passing leaves, the accept-then-insert test of
each half row (4 band tests into a mask that also drops what cannot sort
before the k-th entry at the half's start, then inserts in slot order), and knear8's
thread-local stack with tpurt's clamp at 192 entries.  Each rendering must
return the
twin's ids bit for bit and walk exactly the twin's visits and rows, which
the kernels' bounds are computed from.  The rays are
test_torch_traverse8.py's bunny-3K rays with their special groups (misses,
origins inside the tube, zero and tiny negative components, random rays)
and per-ray t_max at, below and above t_min; the trees are the port's own
band-0.08 builds.
"""

import os
import re

import numpy as np
import pytest
import torch

from tests.test_torch_traverse8 import _bunny_rays, _mt_numpy_det, _trays
from tpurt_torch.accel.bvh8 import build_wide, decode_lane_i32
from tpurt_torch.accel.intersect import DEFAULT_T_MIN
from tpurt_torch.accel.lbvh import build_lbvh
from tpurt_torch.accel.packet import max_cut_leaves, pack_bvh
from tpurt_torch.accel.traverse_ref import BIG_ID, safe_inv
from tpurt_torch.core.geometry import T_MAX, Triangles
from tpurt_torch.kernels import _build
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels import traverse8 as k8

BAND = 0.08
f32 = np.float32


def _cuda_const(source: str, name: str) -> int:
    with open(os.path.join(_build.CSRC, source)) as f:
        m = re.search(rf"constexpr int {name} = (\d+);", f.read())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


STACK_V = _cuda_const("traverse8.cu", "kStackV")


class KernelStack:
    """traverse8.cu's push and pop on a thread's kStackV-entry stack, with
    tpurt's clamp: a push past the last entry overwrites it, a pop of an
    empty stack returns -1."""

    def __init__(self):
        self.stack = [0] * STACK_V
        self.sp = 0

    def push(self, m: int) -> None:
        self.stack[min(self.sp, STACK_V - 1)] = m
        self.sp += 1

    def pop(self) -> int:
        if self.sp <= 0:
            return -1
        top = self.stack[min(max(self.sp - 1, 0), STACK_V - 1)]
        self.sp -= 1
        return top


def _twin_stack(n: int):
    """The twin's stack state for n rays, driven through _Walk.push_pop."""
    w = object.__new__(k8._Walk)
    w.stack = torch.zeros((n, k8.STACKV), dtype=torch.int32)
    w.sp = torch.zeros(n, dtype=torch.int64)
    w.cur = torch.zeros(n, dtype=torch.int64)
    return w


def test_stack_depth_matches_the_twin():
    assert STACK_V == k8.STACKV


@pytest.mark.parametrize("pattern", ["overflow", "random"])
def test_kernel_stack_matches_the_twin_stack_at_overflow(pattern):
    """Visits push their passing internal children in entry order and pop
    the next node: the kernel's stack pops what the twin's clamped
    (R, 192) stack pops, also where pushes run past entry 191 (they
    overwrite it) and where pops run the stack dry (-1)."""
    rng = np.random.default_rng(5)
    n, visits = 6, 260
    if pattern == "overflow":   # 8 pushes a visit: 7 net, past 192 by the 28th
        push = np.ones((visits, n, 8), bool)
        push[:30, 1] = rng.random((30, 8)) < 0.9
        push[30:] = False       # then only pops, to the bottom
    else:
        push = rng.random((visits, n, 8)) < rng.uniform(0.02, 0.15, (1, n, 1))
    meta = rng.integers(0, 1 << 20, (visits, n, 8)).astype(np.int32)
    w, stacks = _twin_stack(n), [KernelStack() for _ in range(n)]
    act = torch.arange(n)
    deepest = 0
    for v in range(visits):
        live = act.numpy()
        want = []
        for i in live:
            st = stacks[i]
            for c in range(8):
                if push[v, i, c]:
                    st.push(int(meta[v, i, c]))
            deepest = max(deepest, st.sp)
            want.append(st.pop())
        act = w.push_pop(act, torch.from_numpy(push[v, live]),
                         torch.from_numpy(meta[v, live]))
        assert w.cur[torch.from_numpy(live)].tolist() == want
        assert w.sp[torch.from_numpy(live)].tolist() == [stacks[i].sp for i in live]
        if not act.numel():
            break
    assert not act.numel()
    if pattern == "overflow":
        assert deepest > STACK_V


# ---------------------------------------------------------------------------
# The kernels' loops, one ray at a time
# ---------------------------------------------------------------------------
class KList:
    """walk_common.cuh's KList: tpurt's bubble insert on a sorted list of
    k (t, id), with knear8's dedup by id."""

    def __init__(self, k: int, dedup: bool):
        self.ts, self.ids, self.dedup = [f32(T_MAX)] * k, [BIG_ID] * k, dedup

    def kth(self):
        return self.ts[-1], self.ids[-1]

    def insert(self, tc, ic) -> None:
        kt, kid = self.kth()
        if not (tc < kt or (tc == kt and ic < kid)):
            return
        if self.dedup and ic in self.ids:
            return
        for i in range(len(self.ts)):
            if tc < self.ts[i] or (tc == self.ts[i] and ic < self.ids[i]):
                self.ts[i], tc = tc, self.ts[i]
                self.ids[i], ic = ic, self.ids[i]

    def out(self):
        return [-1 if x == BIG_ID else x for x in self.ids]


def _knear_row(tri9, tid, o, d, tm, L: KList, counts) -> None:
    """A leaf row as the kernels test it: two halves (knear_half), each its
    4 band tests into an accept mask (with the k-th at the half's start),
    then the accepted slots inserted in order."""
    counts["rows"] += 1
    lo, hi = f32(-BAND), f32(1.0 + BAND)
    for h in (slice(0, 4), slice(4, 8)):
        t, u, v, det = _mt_numpy_det(o[None], d[None], tri9[h])
        kt, kid = L.kth()
        ok = ((np.abs(det) > f32(1e-12)) & (u >= lo) & (v >= lo) & (u + v <= hi)
              & (t > f32(DEFAULT_T_MIN)) & (t < tm) & (tid[h] >= 0)
              & ((t < kt) | ((t == kt) & (tid[h] < kid))))
        for j in np.nonzero(ok)[0]:
            L.insert(t[j], int(tid[h][j]))


def _upper(L: KList, tm):
    kt = L.kth()[0]
    return kt if np.isnan(kt) else (tm if np.isnan(tm) else min(kt, tm))


def _knear8_kernel_loop(wide, o, d, tmax, k):
    """traverse8.cu's knear8_walk, one ray at a time: returns the ids and
    the visits and rows walked."""
    nodes = wide.wrow.reshape(-1, 64)
    box = nodes[:, :48].numpy().reshape(-1, 8, 6)
    meta_all = decode_lane_i32(nodes.view(torch.int32)[:, 48:56]).numpy()
    trows = wide.tri_rows.numpy()[:, :72].reshape(-1, 8, 9)
    tids = decode_lane_i32(wide.tri_rows.view(torch.int32)[:, 72:80]).numpy()
    inv_all = safe_inv(torch.from_numpy(d)).numpy()
    t_min = f32(DEFAULT_T_MIN)
    counts = {"visits": 0, "rows": 0}
    out = np.full((o.shape[0], k), -1, np.int32)
    for i in range(o.shape[0]):
        tm = f32(tmax[i])
        L = KList(k, dedup=True)
        if tm > t_min:
            inv, oi = inv_all[i], o[i] * inv_all[i]
            st, cur = KernelStack(), 0
            while cur >= 0:
                upper = _upper(L, tm)
                leaves, meta = [], None
                while cur >= 0 and not leaves:
                    counts["visits"] += 1
                    with np.errstate(over="ignore", invalid="ignore"):
                        t0, t1 = box[cur, :, :3] * inv - oi, box[cur, :, 3:] * inv - oi
                    near = np.maximum(np.minimum(t0, t1).max(axis=1), t_min)
                    far = np.minimum(np.maximum(t0, t1).min(axis=1), upper)
                    meta = meta_all[cur]
                    for c in np.nonzero(near <= far)[0]:
                        if meta[c] >= 0:
                            st.push(int(meta[c]))
                        else:
                            leaves.append(c)
                    cur = st.pop()
                for c in leaves:
                    nm = ~int(meta[c])
                    for row in range(nm >> 3, (nm >> 3) + max(0, min((nm & 7) + 1,
                                                                     wide.max_rows))):
                        _knear_row(trows[row], tids[row], o[i], d[i], tm, L, counts)
        out[i] = L.out()
    return out, counts


def _knear_bin_kernel_loop(packed, o, d, tmax, k):
    """traverse.cu's knear_bin_walk, one ray at a time."""
    nf, ni = packed.node_f32.numpy(), packed.node_i32.numpy()
    rows = packed.tri_rows.numpy()[:, :72].reshape(-1, 8, 9)
    ids = packed.tri_ids.numpy()
    inv_all = safe_inv(torch.from_numpy(d)).numpy()
    t_min = f32(DEFAULT_T_MIN)
    counts = {"visits": 0, "rows": 0}
    out = np.full((o.shape[0], k), -1, np.int32)
    for i in range(o.shape[0]):
        tm = f32(tmax[i])
        L = KList(k, dedup=False)
        if tm > t_min:
            node = 0
            while node >= 0:
                upper = _upper(L, tm)
                leaf_row = -1
                while node >= 0:
                    counts["visits"] += 1
                    with np.errstate(over="ignore", invalid="ignore"):
                        t0 = (nf[node, 0:3] - o[i]) * inv_all[i]
                        t1 = (nf[node, 3:6] - o[i]) * inv_all[i]
                    tn, tf = np.minimum(t0, t1), np.maximum(t0, t1)
                    near = np.maximum(np.maximum(tn[0], tn[1]), np.maximum(tn[2], t_min))
                    far = np.minimum(np.minimum(tf[0], tf[1]), np.minimum(tf[2], upper))
                    boxed, leaf = bool(near <= far), ni[node, 3] > 0
                    nxt = node + 1 if boxed and not leaf else int(ni[node, 0])
                    if boxed and leaf:
                        leaf_row = int(ni[node, 1])
                        node = nxt
                        break
                    node = nxt
                if leaf_row < 0:
                    break
                _knear_row(rows[leaf_row], ids[leaf_row], o[i], d[i], tm, L, counts)
        out[i] = L.out()
    return out, counts


@pytest.fixture(scope="module")
def scene():
    """bunny-3K's special rays (every 4th of the 64^2 frame, every special
    group kept) and the port's band-0.08 trees."""
    jt, o, d, tmax, groups = _bunny_rays()
    keep = np.zeros(o.shape[0], bool)
    keep[::4] = True
    for g in groups.values():
        keep[g] = True
    tt = Triangles.create(np.asarray(jt.verts), np.asarray(jt.faces), device="cpu")
    bvh = build_lbvh(tt, band=BAND)
    return dict(o=o[keep], d=d[keep], tmax=tmax[keep], wide=build_wide(tt, bvh),
                packed=pack_bvh(tt, bvh, max_cut_leaves(tt.num_tris, bvh.leaf_size)))


@pytest.mark.parametrize("call", ["layers", "occluders"])
def test_knear8_kernel_loop_matches_the_twin(scene, call):
    """The knear8 loop returns the twin's ids on every ray and walks the
    twin's visits and rows (its bound's counts)."""
    k, tm = (4, np.full(scene["o"].shape[0], T_MAX, np.float32)) if call == "layers" \
        else (8, scene["tmax"])
    got, counts = _knear8_kernel_loop(scene["wide"], scene["o"], scene["d"], tm, k)
    stats = {}
    ref = k8.k_nearest_wide8_ref(_trays(scene["o"], scene["d"]), scene["wide"], k, BAND,
                                 t_max=torch.from_numpy(tm), stats=stats).numpy()
    assert (got == ref).all()
    walked = k8.walk_counts(stats)
    assert counts == {"visits": walked["visits"], "rows": walked["rows"]}
    assert (ref >= 0).any(axis=1).mean() > 0.1


@pytest.mark.parametrize("call", ["layers", "occluders"])
def test_knear_bin_kernel_loop_matches_the_twin(scene, call):
    """The knear_bin loop returns the twin's ids on every ray and walks the
    twin's visits and leaves."""
    k, tm = (4, np.full(scene["o"].shape[0], T_MAX, np.float32)) if call == "layers" \
        else (8, scene["tmax"])
    got, counts = _knear_bin_kernel_loop(scene["packed"], scene["o"], scene["d"], tm, k)
    stats = {}
    ref = kb.k_nearest_ids_packed_ref(_trays(scene["o"], scene["d"]), scene["packed"], k,
                                      BAND, t_max=torch.from_numpy(tm), stats=stats).numpy()
    assert (got == ref).all()
    walked = k8.walk_counts(stats)
    assert counts == {"visits": walked["visits"], "rows": walked["rows"]}
    assert (ref >= 0).any(axis=1).mean() > 0.1


# ---------------------------------------------------------------------------
# The loader and the wrappers' checks
# ---------------------------------------------------------------------------
def test_check_aligned_raises_on_a_misaligned_base():
    _build.check_aligned(0, 16, 4096)
    for bad in (4, 8, 12, 20):
        with pytest.raises(ValueError, match="misaligned"):
            _build.check_aligned(16, bad)


def test_build_of_another_source_directory(monkeypatch, tmp_path):
    """Another source directory (a parent commit's kernels, built beside
    these to time them) is built from its own sources, with the same flags,
    into a library named by its own contents."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    log = tmp_path / "calls"
    (home / "bin" / "nvcc").write_text(
        f'#!/bin/sh\necho "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    (home / "bin" / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    other = tmp_path / "other"
    other.mkdir()
    (other / "only.cu").write_text("// one kernel\n")
    path = _build.build(str(other))
    calls = log.read_text().splitlines()
    assert len(calls) == 2 and "only.cu" in calls[0] and "-fmad=false" in calls[0]
    assert "traverse8.cu" not in log.read_text()
    assert path == _build.library_path(str(other)) != _build.library_path()
    (other / "only.cu").write_text("// another kernel\n")
    assert _build.library_path(str(other)) != path
