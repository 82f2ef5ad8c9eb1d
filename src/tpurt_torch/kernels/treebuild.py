"""The LBVH build's Morton and radix-tree stages (counterpart of
``tpurt/kernels/treebuild.py``).

``morton_codes`` and ``radix_tree`` launch the hand-written CUDA kernels in
``csrc/treebuild.cu`` (``morton``, ``radix``) for CUDA tensors and run their
plain-torch twins, ``morton_codes_ref`` and ``radix_tree_ref``, for CPU
tensors.  There is no other route: a CUDA tensor either reaches its kernel
or the call raises.  tpurt kept its XLA build as the default and its Pallas
kernels as test-only twins (Mosaic scalarises the radix search's loads); on
the GPU one thread per point and per node is the natural shape, so here the
kernels are the build's route on the card.

The twins are tpurt's XLA build (``accel/morton.py`` morton3d and
``accel/lbvh.py`` build_radix_tree), whole-array torch ops bit for bit:
codes are int64 holding uint32 values (torch cannot shift uint32 tensors on
every backend, so every multiply and shift is followed by ``& 0xFFFFFFFF``),
and clz is computed exactly.  ``accel/morton.py`` and ``accel/lbvh.py``
import from here, never the other way round.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream

MORTON_BITS = 10  # per axis -> 30-bit codes
# The upper clamp of a normalised coordinate: 1 - 1e-7 rounded to f32, the
# value torch.clamp(x, 0.0, 1.0 - 1e-7) uses on an f32 tensor.  The kernel
# is handed this exact f32.
MORTON_CLAMP_HI = float(np.float32(1.0 - 1e-7))
_U32 = 0xFFFFFFFF
# The radix kernel computes its indices in 32 bits: i + l_max and i - l_max
# stay below 2^32 as unsigned values while N <= 2^30.
MAX_RADIX_KEYS = 1 << 30

# Kernel launches per wrapper since the last reset_launches(); only a real
# CUDA launch counts.
LAUNCHES = {"morton": 0, "radix": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain-torch twins
# ---------------------------------------------------------------------------
def expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits after each of the low 10 bits of x (uint32
    semantics, int64 storage)."""
    x = x.to(torch.int64) & _U32
    x = ((x * 0x00010001) & _U32) & 0xFF0000FF
    x = ((x * 0x00000101) & _U32) & 0x0F00F00F
    x = ((x * 0x00000011) & _U32) & 0xC30C30C3
    x = ((x * 0x00000005) & _U32) & 0x49249249
    return x


def inv_extent(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """1 / max(hi - lo, 1e-12): the per-axis scale both routes normalise by."""
    return 1.0 / torch.clamp_min(hi - lo, 1e-12)


def quantize(p: torch.Tensor, lo: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """Normalize points into [0, 2^10) integer grid coordinates (int64)."""
    x = torch.clamp((p - lo) * inv, 0.0, 1.0 - 1e-7)
    return (x * (1 << MORTON_BITS)).to(torch.int64)


def morton_codes_ref(points: torch.Tensor, lo: torch.Tensor,
                     inv: torch.Tensor) -> torch.Tensor:
    """Plain-torch twin of the morton kernel: the 30-bit Morton code of each
    point (..., 3), normalised by lo and inv (int64 holding uint32)."""
    q = quantize(points, lo, inv)
    return (((expand_bits(q[..., 0]) << 2) & _U32)
            | ((expand_bits(q[..., 1]) << 1) & _U32)
            | expand_bits(q[..., 2]))


def clz32(x: torch.Tensor) -> torch.Tensor:
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
    d = torch.where(x == 0, 32 + clz32(i ^ jc), clz32(x))
    return torch.where(valid, d, -1)


def radix_tree_ref(codes: torch.Tensor):
    """Plain-torch twin of the radix kernel: Karras 2012 over sorted codes
    (N,) >= 2, vectorised over the internal nodes.  Returns (left, right,
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


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------
def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           dev: torch.device) -> None:
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, expected {dev}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed: {_build.error_string(err)}")


def morton_codes(points: torch.Tensor, lo: torch.Tensor,
                 inv: torch.Tensor) -> torch.Tensor:
    """30-bit Morton codes (N,) int64 of (N, 3) f32 points, normalised as
    (p - lo) * inv with lo, inv (3,) f32 (inv from inv_extent)."""
    dev = points.device
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")
    _check("points", points, torch.float32, tuple(points.shape), dev)
    _check("lo", lo, torch.float32, (3,), dev)
    _check("inv", inv, torch.float32, (3,), dev)
    if dev.type == "cpu":
        return morton_codes_ref(points, lo, inv)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = points.shape[0]
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    lib = _build.load()
    with _build.on_device(points):
        err = lib.tpurt_morton(
            _ptr(points), _ptr(lo), _ptr(inv), ctypes.c_float(MORTON_CLAMP_HI), n,
            _ptr(codes), _stream(dev))
    _raise_on(err, "morton")
    LAUNCHES["morton"] += 1
    return codes


def radix_tree(codes: torch.Tensor):
    """Karras radix tree over sorted codes (N,) int64 holding uint32,
    2 <= N <= MAX_RADIX_KEYS: (left, right, parent, first, last) as int32,
    leaf ids offset by N-1 (see radix_tree_ref).  On the card one launch
    writes all five; the outputs are allocated uninitialised."""
    dev = codes.device
    n = codes.shape[0]
    if n < 2:
        raise ValueError(f"a radix tree needs at least 2 codes, got {n}")
    if n > MAX_RADIX_KEYS:
        raise ValueError(f"a radix tree takes at most 2^30 codes (32-bit index "
                         f"arithmetic), got {n}")
    _check("codes", codes, torch.int64, (n,), dev)
    if dev.type == "cpu":
        return radix_tree_ref(codes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    i32 = dict(dtype=torch.int32, device=dev)
    left, right = (torch.empty(n - 1, **i32) for _ in range(2))
    parent, first, last = (torch.empty(2 * n - 1, **i32) for _ in range(3))
    lib = _build.load()
    with _build.on_device(codes):
        err = lib.tpurt_radix(
            _ptr(codes), n, _ptr(left), _ptr(right), _ptr(parent), _ptr(first),
            _ptr(last), _stream(dev))
    _raise_on(err, "radix")
    LAUNCHES["radix"] += 1
    return left, right, parent, first, last
