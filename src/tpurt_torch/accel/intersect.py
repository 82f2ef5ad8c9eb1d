"""Möller–Trumbore ray-triangle intersection and the brute-force oracle
(counterpart of ``tpurt/accel/intersect.py``).

``intersect_brute`` / ``occluded_brute`` test every ray against every
triangle; they are the port's small-scene oracle.  Rays are processed in
chunks so the (rays x triangles) temporaries stay bounded.
"""

from __future__ import annotations

import torch

from tpurt_torch.core.geometry import Hit, Rays, T_MAX, Triangles
from tpurt_torch.core.math import cross, dot

# Rays starting exactly on a surface would self-intersect at t=0; offset.
DEFAULT_T_MIN = 1e-4
# Determinant cutoff for "parallel" rays.
DET_EPS = 1e-12
# Upper bound on the (rays x triangles) pairs evaluated at once.
_PAIRS_PER_CHUNK = 1 << 22


def intersect_tuv(o, d, v0, v1, v2):
    """Unmasked Möller–Trumbore (t, u, v, det) for broadcast-compatible
    batches, with the smooth pseudo-inverse det/(det^2 + DET_EPS) (the
    forward of tpurt's diff/intersect_vjp.intersect_tuv, plus det)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = det / (det * det + DET_EPS)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    return t, u, v, det


def intersect_tri(o, d, v0, v1, v2, t_min: float = DEFAULT_T_MIN):
    """Möller–Trumbore with the accept test.  Returns (t, u, v, hit_mask);
    t is T_MAX where hit_mask is False."""
    t, u, v, det = intersect_tuv(o, d, v0, v1, v2)
    hit = ((det.abs() > DET_EPS) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min))
    return torch.where(hit, t, torch.full_like(t, T_MAX)), u, v, hit


def _chunks(n_rays: int, n_tris: int):
    step = max(1, _PAIRS_PER_CHUNK // max(n_tris, 1))
    return range(0, n_rays, step), step


def intersect_brute(rays: Rays, tris: Triangles, t_min: float = DEFAULT_T_MIN,
                    t_max: float = T_MAX) -> Hit:
    """Closest hit by testing every ray against every triangle; ties go to
    the lowest triangle id (argmin takes the first minimum)."""
    shape = rays.shape
    o = rays.o.reshape(-1, 1, 3)
    d = rays.d.reshape(-1, 1, 3)
    v0, v1, v2 = (c[None] for c in tris.corners())
    starts, step = _chunks(o.shape[0], tris.num_tris)
    parts = []
    for s in starts:
        t, u, v, hit = intersect_tri(o[s:s + step], d[s:s + step], v0, v1, v2,
                                     t_min)
        t = torch.where(hit & (t < t_max), t, torch.full_like(t, T_MAX))
        best = torch.argmin(t, dim=1, keepdim=True)
        t_b = t.gather(1, best)[:, 0]
        ok = t_b < T_MAX
        zero = torch.zeros_like(t_b)
        parts.append((
            t_b,
            torch.where(ok, u.gather(1, best)[:, 0], zero),
            torch.where(ok, v.gather(1, best)[:, 0], zero),
            torch.where(ok, best[:, 0].to(torch.int32),
                        torch.full_like(best[:, 0], -1, dtype=torch.int32)),
        ))
    t, u, v, tri = (torch.cat(x).reshape(shape) for x in zip(*parts))
    return Hit(t=t, u=u, v=v, tri=tri)


def occluded_brute(rays: Rays, tris: Triangles, t_min: float = DEFAULT_T_MIN,
                   t_max=T_MAX) -> torch.Tensor:
    """Any-hit test in (t_min, t_max): True where the segment is blocked.
    t_max is a scalar or a per-ray tensor."""
    o = rays.o.reshape(-1, 1, 3)
    d = rays.d.reshape(-1, 1, 3)
    tmax = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tmax = tmax.expand(rays.shape).reshape(-1, 1)
    v0, v1, v2 = (c[None] for c in tris.corners())
    starts, step = _chunks(o.shape[0], tris.num_tris)
    blocked = []
    for s in starts:
        t, _, _, hit = intersect_tri(o[s:s + step], d[s:s + step], v0, v1, v2,
                                     t_min)
        blocked.append((hit & (t < tmax[s:s + step])).any(dim=1))
    return torch.cat(blocked).reshape(rays.shape)
