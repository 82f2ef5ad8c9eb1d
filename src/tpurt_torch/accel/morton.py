"""30-bit 3D Morton codes of triangle centroids (counterpart of
``tpurt/accel/morton.py``).

tpurt computes in uint32 and relies on its wraparound.  Torch cannot shift
uint32 tensors on every backend, so codes are int64 holding the uint32 value:
every multiply and shift is followed by ``& 0xFFFFFFFF``, which reproduces
the uint32 arithmetic bit for bit.
"""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import AABB, Triangles

MORTON_BITS = 10  # per axis -> 30-bit codes
_U32 = 0xFFFFFFFF


def expand_bits(x: torch.Tensor) -> torch.Tensor:
    """Insert two zero bits after each of the low 10 bits of x (uint32
    semantics, int64 storage)."""
    x = x.to(torch.int64) & _U32
    x = ((x * 0x00010001) & _U32) & 0xFF0000FF
    x = ((x * 0x00000101) & _U32) & 0x0F00F00F
    x = ((x * 0x00000011) & _U32) & 0xC30C30C3
    x = ((x * 0x00000005) & _U32) & 0x49249249
    return x


def quantize(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Normalize points into [0, 2^10) integer grid coordinates (int64)."""
    scale = 1.0 / torch.clamp_min(hi - lo, 1e-12)
    x = torch.clamp((p - lo) * scale, 0.0, 1.0 - 1e-7)
    return (x * (1 << MORTON_BITS)).to(torch.int64)


def morton3d(points: torch.Tensor, bounds: AABB) -> torch.Tensor:
    """30-bit Morton code of each point (..., 3) within bounds (int64)."""
    q = quantize(points, bounds.lo, bounds.hi)
    return (((expand_bits(q[..., 0]) << 2) & _U32)
            | ((expand_bits(q[..., 1]) << 1) & _U32)
            | expand_bits(q[..., 2]))


def triangle_morton_codes(tris: Triangles) -> torch.Tensor:
    """Morton codes of triangle centroids over the centroid bounds."""
    c = tris.centroids()
    return morton3d(c, AABB(lo=c.amin(dim=0), hi=c.amax(dim=0)))
