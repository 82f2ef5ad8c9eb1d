"""Lambertian shading with point-light shadow rays, and area lights:
Monte-Carlo samples on the scene's emissive triangles (counterpart of
``tpurt/render/shade.py``)."""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import PointLight
from tpurt_torch.core.math import cross, dot

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


# ---------------------------------------------------------------------------
# Area lights: emissive triangles sampled by area
# ---------------------------------------------------------------------------
def sample_emitters(generator: torch.Generator, tris, num: int):
    """`num` points on the scene's emissive triangles, drawn from
    `generator` (on the triangles' device; tpurt draws from a jax.random
    key, and the two streams differ).

    Faces are chosen proportional to area x mean emission and points
    uniformly by the sqrt(r) barycentric warp, so the pdf is with respect to
    area: pdf_k = weight_k / (A_k * sum(weights)).  Returns (points (S, 3),
    unit normals (S, 3), Le (S, 3), pdf (S,), any_emitter: a bool scalar
    tensor).  A scene without emitters draws faces uniformly and returns
    pdf 0, which area_light_contrib turns into no light; nothing is read
    back to the host."""
    v0, v1, v2 = tris.corners()
    n_raw = cross(v1 - v0, v2 - v0)
    area = 0.5 * torch.sqrt(torch.clamp_min(dot(n_raw, n_raw), 1e-30))
    w = area * torch.mean(tris.emission, dim=-1)               # (F,)
    total_w = torch.sum(w)
    any_emitter = total_w > 0.0
    probs = torch.where(any_emitter, w / torch.clamp_min(total_w, 1e-30), 0.0)
    # the face choice is structure, not a differentiable quantity: inverse
    # CDF over the weights' running sum in float64 (torch.multinomial would
    # renormalise every weight a draw and refuses more than 2^24 faces)
    cdf = torch.cumsum(torch.where(any_emitter, probs, 1.0).detach().double(), dim=0)
    u = torch.rand(num, generator=generator, device=v0.device, dtype=torch.float64)
    face = torch.searchsorted(cdf, u * cdf[-1], right=True).clamp_max(cdf.shape[0] - 1)
    r = torch.rand((num, 2), generator=generator, device=v0.device, dtype=torch.float32)
    su = torch.sqrt(r[:, 0:1])
    b0 = 1.0 - su
    b1 = r[:, 1:2] * su
    b2 = 1.0 - b0 - b1
    p = b0 * v0[face] + b1 * v1[face] + b2 * v2[face]
    nl = n_raw[face]
    nl = nl / torch.sqrt(torch.clamp_min(dot(nl, nl, keepdims=True), 1e-30))
    le = tris.emission[face]
    pdf = probs[face] / torch.clamp_min(area[face], 1e-30)    # area measure
    return p, nl, le, pdf, any_emitter


def area_light_contrib(p, n, albedo, lp, ln_, le, pdf, visibility) -> torch.Tensor:
    """Monte-Carlo direct lighting from sampled emitter points.

    p, n, albedo: (R, 3); lp, ln_, le: (S, 3); pdf: (S,); visibility:
    (R, S).  Returns (R, 3): the mean over samples of
    albedo / pi * Le * cos_s * cos_l / r^2 / pdf * vis (double-sided
    emitters; a sample of pdf 0 adds nothing)."""
    delta = lp[None, :, :] - p[:, None, :]                     # (R, S, 3)
    r2 = torch.clamp_min(dot(delta, delta), 1e-8)
    wi = delta / torch.sqrt(r2)[..., None]
    cos_s = torch.clamp_min(dot(wi, n[:, None, :]), 0.0)      # (R, S)
    cos_l = torch.abs(dot(wi, ln_[None, :, :]))
    g = cos_s * cos_l / r2 * visibility / torch.clamp_min(pdf[None, :], 1e-30)
    g = torch.where(pdf[None, :] > 0, g, 0.0)
    mc = torch.mean(g[..., None] * le[None, :, :], dim=1)     # (R, 3)
    return albedo * INV_PI * mc
