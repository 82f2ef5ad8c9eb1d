"""30-bit 3D Morton codes of triangle centroids (counterpart of
``tpurt/accel/morton.py``).

The arithmetic lives in ``kernels/treebuild.py``: its ``morton_codes``
launches the CUDA kernel for CUDA tensors and runs the plain-torch twin
``morton_codes_ref`` (tpurt's ``morton3d``, bit for bit) for CPU tensors.
"""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import Triangles
from tpurt_torch.kernels.treebuild import inv_extent, morton_codes
from tpurt_torch.obs.trace import trace_span


def triangle_morton_codes(tris: Triangles) -> torch.Tensor:
    """Morton codes of triangle centroids over the centroid bounds: the
    morton kernel on the card, its twin on the CPU."""
    with trace_span("lbvh.centroid_bounds"):
        c = tris.centroids()
        lo = c.amin(dim=0)
        inv = inv_extent(lo, c.amax(dim=0))
    with trace_span("lbvh.morton"):
        return morton_codes(c, lo, inv)
