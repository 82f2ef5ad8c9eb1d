"""30-bit 3D Morton codes of triangle centroids (counterpart of
``tpurt/accel/morton.py``).

The arithmetic lives in ``kernels/treebuild.py``: its ``morton_codes``
launches the CUDA kernel for CUDA tensors and runs the plain-torch twin
``morton_codes_ref`` (tpurt's ``morton3d``, bit for bit) for CPU tensors.
Codes are int64 holding uint32 values.
"""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import AABB, Triangles
from tpurt_torch.kernels.treebuild import MORTON_BITS, expand_bits, inv_extent, morton_codes
from tpurt_torch.kernels.treebuild import quantize as quantize_inv
from tpurt_torch.obs.trace import trace_span

__all__ = ["expand_bits", "expand_bits_naive", "quantize", "morton3d",
           "triangle_morton_codes"]


def expand_bits_naive(x: torch.Tensor) -> torch.Tensor:
    """Loop-based reference for expand_bits (bit i of x moves to bit 3i)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros_like(x)
    for i in range(MORTON_BITS):
        out = out | (((x >> i) & 1) << (3 * i))
    return out


def quantize(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Normalize points into [0, 2^10) integer grid coordinates (int64)."""
    return quantize_inv(p, lo, inv_extent(lo, hi))


def morton3d(points: torch.Tensor, bounds: AABB) -> torch.Tensor:
    """30-bit Morton code of each point (..., 3) within bounds: the morton
    kernel on the card, its twin on the CPU."""
    lo = bounds.lo.to(torch.float32).contiguous()
    inv = inv_extent(lo, bounds.hi.to(torch.float32)).contiguous()
    flat = points.reshape(-1, 3).to(torch.float32).contiguous()
    return morton_codes(flat, lo, inv).reshape(points.shape[:-1])


def triangle_morton_codes(tris: Triangles) -> torch.Tensor:
    """Morton codes of triangle centroids over the centroid bounds: the
    morton kernel on the card, its twin on the CPU."""
    with trace_span("lbvh.centroid_bounds"):
        c = tris.centroids()
        lo = c.amin(dim=0)
        inv = inv_extent(lo, c.amax(dim=0))
    with trace_span("lbvh.morton"):
        return morton_codes(c, lo, inv)
