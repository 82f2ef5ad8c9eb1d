"""Pinhole camera and primary-ray generation (counterpart of
``tpurt/render/camera.py``)."""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.core.geometry import Camera, Rays
from tpurt_torch.core.math import cross, normalize


def camera_basis(cam: Camera):
    """Right-handed view basis (right, up, forward)."""
    fwd = normalize(cam.target - cam.eye)
    right = normalize(cross(fwd, cam.up))
    up = cross(right, fwd)
    return right, up, fwd


def gen_primary_rays(cam: Camera, jitter: torch.Tensor | None = None) -> Rays:
    """Primary rays for every pixel, row-major (H*W, 3), on the camera's
    device.  jitter: optional (H*W, 2) sub-pixel offsets in [0, 1); pixel
    centres by default.  Directions are normalized."""
    h, w = cam.height, cam.width
    dev = cam.eye.device
    right, up, fwd = camera_basis(cam)
    tan_half = torch.tan(torch.deg2rad(cam.fov_y_deg) * 0.5)
    aspect = w / h
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    if jitter is None:
        jx = jy = 0.5
    else:
        jx, jy = jitter[..., 0], jitter[..., 1]
    px = ((xx + jx) / w * 2.0 - 1.0) * tan_half * aspect
    py = (1.0 - (yy + jy) / h * 2.0) * tan_half
    d = normalize(px[:, None] * right + py[:, None] * up + fwd)
    return Rays(o=cam.eye.expand(d.shape).contiguous(), d=d)


def gen_tile_rays(cam: Camera, y0: int, x0: int, th: int, tw: int) -> Rays:
    """Rays through the pixel centres of one (th x tw) tile anchored at
    pixel (y0, x0), row-major within the tile."""
    h, w = cam.height, cam.width
    dev = cam.eye.device
    right, up, fwd = camera_basis(cam)
    tan_half = torch.tan(torch.deg2rad(cam.fov_y_deg) * 0.5)
    aspect = w / h
    yy = y0 + torch.arange(th, dtype=torch.float32, device=dev)[:, None].expand(th, tw)
    xx = x0 + torch.arange(tw, dtype=torch.float32, device=dev)[None, :].expand(th, tw)
    px = ((xx.reshape(-1) + 0.5) / w * 2.0 - 1.0) * tan_half * aspect
    py = (1.0 - (yy.reshape(-1) + 0.5) / h * 2.0) * tan_half
    d = normalize(px[:, None] * right + py[:, None] * up + fwd)
    return Rays(o=cam.eye.expand(d.shape).contiguous(), d=d)


def pixel_morton_perm(height: int, width: int):
    """Morton (Z-order) permutation of row-major pixel indices, as numpy
    int64 arrays (perm, inv): rays_morton = rays_flat[perm] and
    x_flat = x_morton[inv].  Z-order keeps neighbouring rays on neighbouring
    pixels, so the 32 rays of a warp walk similar subtrees."""
    yy, xx = np.mgrid[0:height, 0:width]

    def _spread(v):  # interleave-ready 16-bit spread (Morton magic constants)
        v = v.astype(np.uint32)
        v = (v | (v << 8)) & 0x00FF00FF
        v = (v | (v << 4)) & 0x0F0F0F0F
        v = (v | (v << 2)) & 0x33333333
        v = (v | (v << 1)) & 0x55555555
        return v

    code = (_spread(xx) | (_spread(yy) << 1)).reshape(-1)
    perm = np.argsort(code, kind="stable")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    return perm, inv
