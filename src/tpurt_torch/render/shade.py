"""Lambertian shading with point-light shadow rays (counterpart of
``tpurt/render/shade.py``, point lights only)."""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import PointLight
from tpurt_torch.core.math import dot

INV_PI = 0.3183098861837907


def light_dirs(p: torch.Tensor, lights: PointLight):
    """p (R, 3) -> unit directions wi (R, L, 3), distances (R, L) and the
    I/r^2 falloff (R, L, 3)."""
    delta = lights.pos[None, :, :] - p[:, None, :]
    dist = torch.sqrt(torch.clamp_min(dot(delta, delta), 1e-12))
    wi = delta / dist[..., None]
    falloff = lights.intensity[None] / torch.clamp_min(dist * dist, 1e-8)[..., None]
    return wi, dist, falloff


def shade_lambert(p, n, albedo, emission, lights: PointLight, visibility,
                  ambient) -> torch.Tensor:
    """Lambertian direct lighting: p, n, albedo, emission (R, 3);
    visibility (R, L) in [0, 1]; ambient (3,)."""
    wi, _, falloff = light_dirs(p, lights)
    ndotl = torch.clamp_min(dot(wi, n[:, None, :]), 0.0)
    direct = torch.sum(falloff * (ndotl * visibility)[..., None], dim=1)
    return emission + albedo * (INV_PI * direct + ambient[None, :])


def face_forward(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Flip normals to face the incoming ray (double-sided shading)."""
    return torch.where(dot(n, d, keepdims=True) > 0.0, -n, n)
