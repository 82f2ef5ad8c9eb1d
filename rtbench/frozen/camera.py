"""Pinhole camera rays, frozen.

A copy of the port's ``gen_primary_rays`` and ``camera_basis``
(``render/camera.py``) with the vector helpers they use
(``core/math.py``): every pixel's ray through its centre, row-major, made
on the device by the same torch operations, so the rays are bitwise the
port's own (``rtbench/tests`` holds them so).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class View:
    """A camera: eye, target and up as (3,) f32 tensors on the device,
    vertical field of view in degrees (a 0-d f32 tensor), size in pixels."""

    eye: torch.Tensor
    target: torch.Tensor
    up: torch.Tensor
    fov_y_deg: torch.Tensor
    width: int
    height: int

    @classmethod
    def create(cls, eye, target, fov_y_deg: float, width: int, height: int,
               device, up=(0.0, 1.0, 0.0)) -> "View":
        def f32(x):
            return torch.from_numpy(np.array(x, np.float32)).to(device)
        return cls(eye=f32(eye), target=f32(target), up=f32(up),
                   fov_y_deg=f32(fov_y_deg), width=width, height=height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height


def _dot(a, b, keepdims=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def _normalize(a):
    return a / torch.sqrt(torch.clamp_min(_dot(a, a, keepdims=True), 1e-30))


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def basis(view: View):
    """Right-handed view basis (right, up, forward)."""
    fwd = _normalize(view.target - view.eye)
    right = _normalize(_cross(fwd, view.up))
    up = _cross(right, fwd)
    return right, up, fwd


def primary_rays(view: View) -> tuple[torch.Tensor, torch.Tensor]:
    """(origins, unit directions), each (H*W, 3) f32, row-major."""
    h, w = view.height, view.width
    dev = view.eye.device
    right, up, fwd = basis(view)
    tan_half = torch.tan(torch.deg2rad(view.fov_y_deg) * 0.5)
    aspect = w / h
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    px = ((xx + 0.5) / w * 2.0 - 1.0) * tan_half * aspect
    py = (1.0 - (yy + 0.5) / h * 2.0) * tan_half
    d = _normalize(px[:, None] * right + py[:, None] * up + fwd)
    return view.eye.expand(d.shape).contiguous(), d
