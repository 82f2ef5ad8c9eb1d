"""Geometry core: rays, triangles, boxes, hits, camera and point lights.

Counterpart of ``tpurt/core/geometry.py``.  Containers are dataclasses
holding tensors in structure-of-arrays layout (float32 geometry, int32 ids);
``dataclasses.replace`` takes the place of the pytrees' ``.replace``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# Sentinel triangle id for "no hit".
MISS = -1
# Large-but-finite ray parameter used as "infinity".
T_MAX = 1e30


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device)


@dataclass
class Rays:
    """A batch of rays: o, d (..., 3) float32; t is in units of |d|."""

    o: torch.Tensor
    d: torch.Tensor

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.o.shape[:-1])


@dataclass
class Triangles:
    """Indexed triangle soup: verts (V, 3) f32, faces (F, 3) i32, per-face
    albedo and emission (F, 3) f32."""

    verts: torch.Tensor
    faces: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor

    @classmethod
    def create(cls, verts, faces, albedo=None, emission=None,
               device="cpu") -> "Triangles":
        verts = _f32(verts, device)
        faces = torch.from_numpy(np.array(faces, np.int32)).to(device)
        n = faces.shape[0]
        albedo = 0.7 if albedo is None else albedo
        emission = 0.0 if emission is None else emission
        albedo = _f32(np.broadcast_to(np.asarray(albedo, np.float32), (n, 3)),
                      device)
        emission = _f32(
            np.broadcast_to(np.asarray(emission, np.float32), (n, 3)), device)
        return cls(verts=verts, faces=faces, albedo=albedo, emission=emission)

    @property
    def num_tris(self) -> int:
        return self.faces.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    def corners(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        f = self.faces.long()
        return self.verts[f[:, 0]], self.verts[f[:, 1]], self.verts[f[:, 2]]

    def centroids(self) -> torch.Tensor:
        v0, v1, v2 = self.corners()
        return (v0 + v1 + v2) / 3.0


@dataclass
class AABB:
    """Axis-aligned bounding box(es): lo/hi (..., 3)."""

    lo: torch.Tensor
    hi: torch.Tensor


@dataclass
class Hit:
    """Per-ray closest hit: t (T_MAX on a miss), barycentrics u, v and the
    int32 triangle id (MISS on a miss)."""

    t: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    tri: torch.Tensor

    @property
    def valid(self) -> torch.Tensor:
        return self.tri >= 0


@dataclass
class Camera:
    """Pinhole camera; eye/target/up (3,) and fov_y_deg () f32 tensors."""

    eye: torch.Tensor
    target: torch.Tensor
    up: torch.Tensor
    fov_y_deg: torch.Tensor
    width: int = 256
    height: int = 256

    @classmethod
    def create(cls, eye, target, up=(0.0, 1.0, 0.0), fov_y_deg: float = 45.0,
               width: int = 256, height: int = 256,
               device="cpu") -> "Camera":
        return cls(eye=_f32(eye, device), target=_f32(target, device),
                   up=_f32(up, device), fov_y_deg=_f32(fov_y_deg, device),
                   width=width, height=height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


@dataclass
class PointLight:
    """Point light(s): pos (L, 3), intensity (L, 3), 1/r^2 falloff."""

    pos: torch.Tensor
    intensity: torch.Tensor

    @classmethod
    def create(cls, pos, intensity, device="cpu") -> "PointLight":
        pos = np.atleast_2d(np.asarray(pos, np.float32))
        inten = np.broadcast_to(
            np.atleast_2d(np.asarray(intensity, np.float32)), pos.shape)
        return cls(pos=_f32(pos, device), intensity=_f32(inten, device))
