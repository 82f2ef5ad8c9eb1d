"""The build kernels' module (kernels/treebuild.py) against tpurt: the
plain-torch twins bitwise against tpurt's interpret-mode Pallas kernels and
its XLA build, a scalar per-node rendering of the CUDA radix kernel, the
work of Karras's search that chip_smoke.py's radix bound counts, the CPU
route of the wrappers and the clamp constant handed to the Morton kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.accel.lbvh import build_radix_tree as j_build_radix_tree
from tpurt.accel.morton import morton3d as j_morton3d
from tpurt.core.geometry import AABB as JAABB
from tpurt.kernels.treebuild import morton_codes_pallas, radix_tree_pallas

from chip_smoke import differing_elements, karras_work, prefilled_radix_outputs
from tpurt_torch.accel.morton import triangle_morton_codes
from tpurt_torch.core.geometry import Triangles
from tpurt_torch.kernels import treebuild as tb


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3, 5, (n, 3)).astype(np.float32)


def _dup_codes(n, seed=1, hi=2**12):
    """Sorted uint32 codes with runs of equal values (hi << n)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, hi, n, dtype=np.uint32))


def _lo_inv(p: torch.Tensor):
    lo = p.amin(dim=0)
    return lo, tb.inv_extent(lo, p.amax(dim=0))


def test_clamp_constant_is_the_twins_f32():
    """The kernel gets 1 - 1e-7 rounded to f32: the value torch.clamp uses
    on an f32 tensor, and the f32 that 1.0f - 1e-7f rounds to as well."""
    c = np.float32(1.0 - 1e-7)
    assert tb.MORTON_CLAMP_HI == float(c)
    assert c == np.float32(np.float32(1.0) - np.float32(1e-7))
    x = torch.clamp(torch.tensor([2.0, 0.5]), 0.0, 1.0 - 1e-7)
    assert x[0].item() == tb.MORTON_CLAMP_HI
    assert int(x[0] * (1 << tb.MORTON_BITS)) == 1023


@pytest.mark.parametrize("n", [1, 1000, 3001])
def test_morton_twin_matches_pallas_interpret(n):
    pts = _points(n, seed=n)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    ref = np.asarray(morton_codes_pallas(jnp.asarray(pts),
                                         JAABB(lo=jnp.asarray(lo), hi=jnp.asarray(hi))))
    p = torch.from_numpy(pts)
    got = tb.morton_codes_ref(p, torch.from_numpy(lo), tb.inv_extent(
        torch.from_numpy(lo), torch.from_numpy(hi)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


def test_morton_twin_matches_tpurt_xla_with_clamped_points():
    """Points outside the bounds clamp to the grid's ends; a flat axis
    (hi == lo) normalises by 1e-12."""
    pts = _points(20_000, seed=3)
    pts[:50] *= 3.0                              # outside the bounds
    pts[:, 1] = 0.25                             # a flat axis
    lo = np.array([-3.0, 0.25, -3.0], np.float32)
    hi = np.array([5.0, 0.25, 5.0], np.float32)
    ref = np.asarray(j_morton3d(jnp.asarray(pts), JAABB(lo=jnp.asarray(lo), hi=jnp.asarray(hi))))
    lo_t = torch.from_numpy(lo)
    got = tb.morton_codes_ref(torch.from_numpy(pts), lo_t, tb.inv_extent(lo_t, torch.from_numpy(hi)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("case", ["random100", "dups100", "equal33", "n2", "n2_equal"])
def test_radix_twin_matches_pallas_interpret(case):
    codes = {"random100": np.sort(np.random.default_rng(5).integers(
                 0, 2**30, 100, dtype=np.uint32)),
             "dups100": _dup_codes(100, hi=40),
             "equal33": np.full(33, 12345, np.uint32),
             "n2": np.array([3, 7], np.uint32),
             "n2_equal": np.array([5, 5], np.uint32)}[case]
    ref = [np.asarray(x) for x in radix_tree_pallas(jnp.asarray(codes))]
    got = tb.radix_tree_ref(torch.from_numpy(codes.astype(np.int64)))
    for g, r in zip(got, ref):  # left, right, parent
        np.testing.assert_array_equal(g.numpy(), r)


def test_radix_twin_matches_tpurt_xla_build_with_duplicate_runs():
    codes = _dup_codes(20_000, hi=2**12)
    assert len(np.unique(codes)) < len(codes) // 2
    ref = [np.asarray(x) for x in j_build_radix_tree(jnp.asarray(codes))]
    got = tb.radix_tree_ref(torch.from_numpy(codes.astype(np.int64)))
    for name, g, r in zip(("left", "right", "parent", "first", "last"), got, ref):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def _clz(x: int) -> int:
    return 32 - int(x).bit_length()


def _delta_fn(codes: np.ndarray, counter: list):
    """delta(i, j) of the sorted keys, -1 out of range; counter[0] counts
    the evaluations that load a code, counter[1] all of them."""
    n = len(codes)
    c = [int(x) for x in codes]

    def delta(i, j):
        counter[1] += 1
        if j < 0 or j >= n:
            return -1
        counter[0] += 1
        x = c[i] ^ c[j]
        return 32 + _clz(i ^ j) if x == 0 else _clz(x)
    return delta


_U32 = 0xFFFFFFFF
_UNWRITTEN = -7  # what the outputs hold before the threads run


def _radix_loop(codes: np.ndarray):
    """treebuild.cu's radix_kernel, thread by thread in Python, in its
    uint32 index arithmetic: Karras's search (2012, fig. 4; the range end by
    an exponential then a binary search, the split over t = ceil(l/2),
    ceil(l/4), ..., 1), thread t writing leaf t's first and last and thread
    0 the root's parent, into outputs that start unwritten.  Returns the
    five outputs and (the delta evaluations that load a code, all of
    them), the node's own code counted as a load."""
    n = len(codes)
    counter = [n - 1, 0]
    delta = _delta_fn(codes, counter)

    def step(i, m, d):  # i + m d as a uint32; below 0 it wraps above n
        return (i + m if d > 0 else i - m) & _U32

    def dl(i, j):
        return delta(i, j if j < n else -1)

    left, right = (np.full(n - 1, _UNWRITTEN, np.int32) for _ in range(2))
    parent, first, last = (np.full(2 * n - 1, _UNWRITTEN, np.int32) for _ in range(3))
    for t in range(n):
        first[n - 1 + t] = last[n - 1 + t] = t
        if t == 0:
            parent[0] = -1
        if t >= n - 1:
            continue
        i = t
        up, down = dl(i, i + 1), dl(i, step(i, 1, -1))
        d = 1 if up - down >= 0 else -1
        dmin = down if d > 0 else up
        lmax = 2
        while dl(i, step(i, lmax, d)) > dmin:
            lmax = (lmax << 1) & _U32
        l, h = 0, lmax >> 1
        while h > 0:
            if dl(i, step(i, l + h, d)) > dmin:
                l += h
            h >>= 1
        j = step(i, l, d)
        dnode = dl(i, j)
        s, h = 0, l
        while True:
            h = (h + 1) >> 1
            if dl(i, step(i, s + h, d)) > dnode:
                s += h
            if h <= 1:
                break
        gamma = step(i, s, d) + (-1 if d < 0 else 0)
        lo, hi = min(i, j), max(i, j)
        left[t] = n - 1 + gamma if lo == gamma else gamma
        right[t] = n + gamma if hi == gamma + 1 else gamma + 1
        first[t], last[t] = lo, hi
        parent[left[t]] = parent[right[t]] = t
    return (left, right, parent, first, last), (counter[0], counter[1])


def _codes(case: str) -> np.ndarray:
    rng = np.random.default_rng(6)
    if case.startswith("pow2_"):  # N around 2^k, with duplicate runs
        k, off = (int(x) for x in case[5:].split("_"))
        return _dup_codes((1 << k) + off - 1, seed=k + off, hi=1 << (k + 1))
    return {"dups300": _dup_codes(300, hi=200), "equal64": np.full(64, 9, np.uint32),
            "random300": np.sort(rng.integers(0, 2**30, 300, dtype=np.uint32)),
            "n2": np.array([1, 2], np.uint32),
            "equal4097": np.full(4097, 77, np.uint32)}[case]


@pytest.mark.parametrize("case", ["dups300", "random300", "equal64", "n2"])
def test_radix_twin_matches_the_kernels_scalar_walk_and_counts_its_loads(case):
    """The twin against the kernel's loop, which writes every output
    element; the bound's count of Karras's search (karras_work, read off the
    tree) is the loop's own count of its delta evaluations."""
    codes = _codes(case)
    got = tb.radix_tree_ref(torch.from_numpy(codes.astype(np.int64)))
    loop, work = _radix_loop(codes)
    for g, r in zip(got, loop):
        np.testing.assert_array_equal(g.numpy(), r)
    n = len(codes)
    assert karras_work(got, n) == work
    assert work[0] < 66 * (n - 1)


@pytest.mark.parametrize("case", [f"pow2_{k}_{off}" for k in (2, 5, 8, 11)
                                  for off in (0, 1, 2)] + ["equal4097"])
def test_radix_kernel_loop_matches_the_twin_around_powers_of_two(case):
    """N = 2^k - 1, 2^k, 2^k + 1, where the exponential search's last
    candidate leaves the keys on either side; and 4,097 equal codes, where
    the index bits alone order the keys."""
    codes = _codes(case)
    got = tb.radix_tree_ref(torch.from_numpy(codes.astype(np.int64)))
    loop, work = _radix_loop(codes)
    for name, g, r in zip(("left", "right", "parent", "first", "last"), got, loop):
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
    assert karras_work(got, len(codes)) == work


def test_build_ab_counts_differing_bits_per_output():
    """[build_ab]'s comparison: per radix output (or one codes tensor) the
    elements whose bits differ; another dtype or shape differs in all of
    its elements.  The outputs as the wrapper made them before the kernel
    wrote the whole stage hold the twin's leaves and root."""
    codes = torch.from_numpy(_dup_codes(300, hi=200).astype(np.int64))
    ref = tb.radix_tree_ref(codes)
    same = tuple(x.clone() for x in ref)
    assert differing_elements(same, ref) == dict.fromkeys(
        ("left", "right", "parent", "first", "last"), 0)
    same[2][[5, 77]] += 1
    got = differing_elements(same, ref)
    assert got["parent"] == 2 and sum(got.values()) == 2
    assert differing_elements(same[:4] + (ref[4].long(),), ref)["last"] == ref[4].numel()
    assert differing_elements(same[:1] + (ref[1][:-1],) + same[2:], ref)["right"] == 299
    c = codes.clone()
    assert differing_elements(c, codes) == {"codes": 0}
    c[3] ^= 1 << 20
    assert differing_elements(c, codes) == {"codes": 1}
    pre = prefilled_radix_outputs(300, "cpu")
    assert int(pre[2][0]) == int(ref[2][0]) == -1
    for k in (3, 4):
        assert torch.equal(pre[k][299:], ref[k][299:])


def test_wrappers_route_cpu_tensors_to_the_twins_without_a_launch():
    tb.reset_launches()
    p = torch.from_numpy(_points(500))
    lo, inv = _lo_inv(p)
    assert torch.equal(tb.morton_codes(p, lo, inv), tb.morton_codes_ref(p, lo, inv))
    codes = torch.from_numpy(_dup_codes(500, hi=64).astype(np.int64))
    for g, r in zip(tb.radix_tree(codes), tb.radix_tree_ref(codes)):
        assert torch.equal(g, r)
    two = tb.radix_tree(torch.tensor([4, 4], dtype=torch.int64))
    assert [x.tolist() for x in two] == [[1], [2], [-1, 0, 0], [0, 0, 1], [1, 0, 1]]
    assert tb.LAUNCHES == {"morton": 0, "radix": 0}


@pytest.mark.parametrize("bad,err", [
    (lambda p, lo, inv: (p.double(), lo, inv), TypeError),
    (lambda p, lo, inv: (p[:, :2].contiguous(), lo, inv), ValueError),
    (lambda p, lo, inv: (p.T.contiguous().T, lo, inv), ValueError),
    (lambda p, lo, inv: (p, lo[:2], inv), ValueError),
    (lambda p, lo, inv: (p, lo, inv.to("meta")), ValueError),
])
def test_morton_wrapper_refuses_what_the_kernel_does_not_take(bad, err):
    p = torch.from_numpy(_points(64))
    with pytest.raises(err):
        tb.morton_codes(*bad(p, *_lo_inv(p)))


def test_radix_wrapper_refuses_short_and_mistyped_codes():
    with pytest.raises(ValueError):
        tb.radix_tree(torch.tensor([1], dtype=torch.int64))
    with pytest.raises(TypeError):
        tb.radix_tree(torch.tensor([1, 2], dtype=torch.int32))


def test_radix_wrapper_refuses_more_than_2_to_the_30_codes():
    """The kernel's 32-bit index arithmetic holds up to N = 2^30; the
    wrapper refuses more before it looks at the device (an expanded view
    stands in for 8 GiB of codes)."""
    big = torch.zeros(1, dtype=torch.int64).expand(tb.MAX_RADIX_KEYS + 1)
    with pytest.raises(ValueError, match=r"2\^30"):
        tb.radix_tree(big)
    assert tb.MAX_RADIX_KEYS == 1 << 30


def test_triangle_morton_codes_match_tpurt():
    pts = _points(3 * 700, seed=8)
    tris = Triangles.create(pts, np.arange(len(pts)).reshape(-1, 3), device="cpu")
    from tpurt.accel.morton import triangle_morton_codes as j_tri_morton
    from tpurt.core.geometry import Triangles as JTriangles

    ref = np.asarray(j_tri_morton(JTriangles.create(pts, np.arange(len(pts)).reshape(-1, 3))))
    np.testing.assert_array_equal(triangle_morton_codes(tris).numpy(), ref.astype(np.int64))
