"""Build the port's objects from plain numpy arrays.

The tests turn tpurt's objects into numpy arrays and hand them over through
these functions, so a structure built by one package can be fed to the
other's traversal: a kernel fault then shows apart from a build fault.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.accel.bvh8 import WideBVH
from tpurt_torch.accel.lbvh import BVH
from tpurt_torch.core.geometry import Camera, PointLight, Triangles
from tpurt_torch.core.scene import Scene

_I32 = np.int32


def _t(x, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype)).to(device)


def scene_from_numpy(*, verts, faces, albedo, emission, light_pos,
                     light_intensity, background, ambient,
                     device="cpu") -> Scene:
    tris = Triangles.create(verts, faces, albedo, emission, device=device)
    lights = PointLight.create(light_pos, light_intensity, device=device)
    return Scene.create(tris, lights, background, ambient)


def camera_from_numpy(*, eye, target, up, fov_y_deg, width, height,
                      device="cpu") -> Camera:
    return Camera.create(eye, target, up, float(np.asarray(fov_y_deg)),
                         int(width), int(height), device=device)


def bvh_from_numpy(*, left, right, parent, first, last, node_lo, node_hi,
                   codes, tri_order, band=0.0, device="cpu") -> BVH:
    """codes may be uint32 (tpurt) or int64; the port keeps int64."""
    i32 = {k: _t(v, _I32, device) for k, v in dict(
        left=left, right=right, parent=parent, first=first, last=last,
        tri_order=tri_order).items()}
    return BVH(node_lo=_t(node_lo, np.float32, device),
               node_hi=_t(node_hi, np.float32, device),
               codes=_t(codes, np.int64, device), band=float(band), **i32)


def wide_from_numpy(*, wrow, tri_rows, entry_node, entry_meta, own_node,
                    escape, has_int, row_tids, max_stack, max_rows, band=0.0,
                    device="cpu") -> WideBVH:
    i32 = {k: _t(v, _I32, device) for k, v in dict(
        entry_node=entry_node, entry_meta=entry_meta, own_node=own_node,
        escape=escape, has_int=has_int, row_tids=row_tids).items()}
    return WideBVH(wrow=_t(wrow, np.float32, device),
                   tri_rows=_t(tri_rows, np.float32, device),
                   band=float(band), max_stack=int(max_stack),
                   max_rows=int(max_rows), **i32)
