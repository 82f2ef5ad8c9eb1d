"""Soft visibility: K-layer alpha compositing over extended hits
(counterpart of ``tpurt/diff/softvis.py``).

Every triangle is intersected with a barycentric band, so rays that nearly
hit it still record it; each recorded hit gets the coverage
alpha = sigmoid(sharpness * s) (s = min(u, v, 1 - u - v), positive inside),
times a compact-support window that is exactly 0 at s <= -band, so a
candidate enters or leaves any engine's candidate set only where its alpha
is 0.  Pixels composite front to back, and shadow segments take the
product of (1 - alpha) over candidate occluders, weighted by a smooth ramp
in t and a grazing-incidence gate.  The render is then a smooth function of
vertices and albedo, and autograd through it matches finite differences.

Shapes follow tpurt's: the public functions take the same layouts (the SoA
core keeps the ray index last, vectors as lists of 3 components), so the
tests compare like with like.
"""

from __future__ import annotations

import torch

from tpurt_torch.accel.intersect import DEFAULT_T_MIN, DET_EPS
from tpurt_torch.core.geometry import KHits, Rays, T_MAX, Triangles
from tpurt_torch.core.math import cross, dot
from tpurt_torch.diff.gather_grad import gather_verts
from tpurt_torch.diff.intersect_vjp import intersect_tuv

# Grazing-incidence gate: coverage fades out for faces seen nearly edge-on
# (|cos(ray, normal)| below ~1e-2), where the smooth pseudo-inverse drags
# (u, v, t) back through the band as det sweeps through ~sqrt(eps).
DET_GATE_LO = 2e-3
DET_GATE_HI = 2e-2

# Soft shadow t-window: occluder weight ramps up over [RAMP_NEAR0,
# RAMP_NEAR1] * t_max and down over [RAMP_FAR0, RAMP_FAR1] * t_max, so faces
# next to the segment's ends never enter or leave it with a large alpha.
RAMP_NEAR0 = 0.004
RAMP_NEAR1 = 0.04
RAMP_FAR0 = 0.96
RAMP_FAR1 = 0.996

# Upper bound on the (rays x triangles) pairs k_nearest_brute evaluates at once.
_PAIRS_PER_CHUNK = 1 << 22


def signed_edge_distance(u, v):
    """Signed barycentric distance to the nearest edge (positive inside)."""
    return torch.minimum(torch.minimum(u, v), 1.0 - u - v)


def _smoothstep01(x):
    return x * x * (3.0 - 2.0 * x)


def det_gate(cos_dn):
    """Smooth 0 -> 1 gate on |cos| between ray direction and face normal."""
    return _smoothstep01(torch.clamp(
        (cos_dn.abs() - DET_GATE_LO) / (DET_GATE_HI - DET_GATE_LO), 0.0, 1.0))


def coverage(u, v, sharpness, valid, band: float = 0.0):
    """Soft coverage in [0, 1], 0 where not valid.  band > 0 multiplies a C^1
    window that is 0 at s <= -band and 1 at s >= -band/2; band = 0 is the
    raw sigmoid."""
    s = signed_edge_distance(u, v)
    a = torch.sigmoid(sharpness * s)
    if band and band > 0.0:
        a = a * _smoothstep01(torch.clamp((s + band) / (0.5 * band), 0.0, 1.0))
    return torch.where(valid, a, 0.0)


def hard_coverage(u, v, valid):
    s = signed_edge_distance(u, v)
    return torch.where(valid & (s >= 0.0), 1.0, 0.0)


def composite(alphas, colors, background):
    """Front-to-back compositing: alphas (R, K), colors (R, K, 3),
    background (3,) or (R, 3) -> (R, 3)."""
    trans = torch.cumprod(1.0 - alphas, dim=-1)
    t_before = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    out = torch.sum((alphas * t_before)[..., None] * colors, dim=-2)
    return out + trans[..., -1:] * background.expand(out.shape)


def transmittance(alphas):
    """Product of (1 - alpha) over the last axis: soft visibility."""
    return torch.prod(1.0 - alphas, dim=-1)


def _extended_tuv(o, d, tris: Triangles, band, t_min, t_max):
    """(t, u, v, ext_hit, gate) of every (ray, triangle) pair within the
    band; o, d (R, 1, 3).  t is T_MAX where not ext_hit; gate is det_gate
    of the incidence, which callers multiply into coverage."""
    v0, v1, v2 = tris.corners()
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    pvec = cross(d, e2[None])
    det = dot(e1[None], pvec)
    inv_det = det / (det * det + DET_EPS)
    tvec = o - v0[None]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1[None])
    v = dot(d, qvec) * inv_det
    t = dot(e2[None], qvec) * inv_det
    cos_dn = det / torch.sqrt(torch.clamp_min(dot(d, d) * dot(n, n)[None], 1e-30))
    ok = ((det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
          & (u + v <= 1.0 + band) & (t > t_min) & (t < t_max))
    return torch.where(ok, t, T_MAX), u, v, ok, det_gate(cos_dn)


def k_nearest_brute(rays: Rays, tris: Triangles, k: int = 4, band: float = 0.08,
                    t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> KHits:
    """K nearest extended hits per ray by testing every triangle.  Ties in t
    go to the lower triangle id (a stable sort, as jax.lax.top_k).  t_max is
    a scalar or per ray.  k is clamped to the triangle count."""
    shape = rays.shape
    o = rays.o.reshape(-1, 1, 3)
    d = rays.d.reshape(-1, 1, 3)
    k = min(k, tris.num_tris)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    per_ray = tm.ndim > 0
    if per_ray:
        tm = tm.reshape(-1, 1)
    step = max(1, _PAIRS_PER_CHUNK // max(tris.num_tris, 1))
    parts = []
    for s in range(0, o.shape[0], step):
        t, u, v, ok, _ = _extended_tuv(o[s:s + step], d[s:s + step], tris, band,
                                       t_min, tm[s:s + step] if per_ray else tm)
        tt, idx = torch.sort(t, dim=1, stable=True)
        tt, idx = tt[:, :k], idx[:, :k]
        valid = ok.gather(1, idx) & (tt < T_MAX)
        parts.append((tt, u.gather(1, idx), v.gather(1, idx),
                      torch.where(valid, idx, -1).to(torch.int32)))
    t, u, v, tri = (torch.cat(x).reshape(*shape, k) for x in zip(*parts))
    return KHits(t=t, u=u, v=v, tri=tri)


def shadow_t_ramp(t, t_max):
    """Smooth occluder weight in (0, t_max): 0 at both ends, 1 between."""
    x = t / torch.clamp_min(t_max, 1e-12)
    up = torch.clamp((x - RAMP_NEAR0) / (RAMP_NEAR1 - RAMP_NEAR0), 0.0, 1.0)
    dn = torch.clamp((RAMP_FAR1 - x) / (RAMP_FAR1 - RAMP_FAR0), 0.0, 1.0)
    return _smoothstep01(up) * _smoothstep01(dn)


def soft_occlusion_from_ids(rays: Rays, tris: Triangles, ids: torch.Tensor,
                            sharpness: float, band: float = 0.08,
                            t_min: float = DEFAULT_T_MIN, t_max=T_MAX) -> torch.Tensor:
    """Differentiable transmittance of each shadow segment from a discrete
    occluder-id list: ids (R, K) int32 candidates per flat ray (-1 padding,
    from any engine, no gradient); (t, u, v) are recomputed from the
    gathered vertices, so the gradient is the brute-force product's over
    the same occluders.  t_max is a scalar or per ray; returns the rays'
    shape."""
    ids = ids.detach()
    o = rays.o.reshape(-1, 1, 3)
    d = rays.d.reshape(-1, 1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tmax = tm.reshape(-1, 1) if tm.ndim > 0 else tm
    f = tris.faces.long()[ids.clamp_min(0).long()]           # (R, K, 3)
    v0, v1, v2 = (tris.verts[f[..., c]] for c in range(3))
    e1, e2 = v1 - v0, v2 - v0
    n = cross(e1, e2)
    t, u, v = intersect_tuv(o, d, v0, v1, v2)
    det = dot(e1, cross(d.expand_as(e2), e2))
    cos_dn = det / torch.sqrt(torch.clamp_min(dot(d, d) * dot(n, n), 1e-30))
    ok = ((ids >= 0) & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
          & (u + v <= 1.0 + band) & (t > t_min) & (t < 2.0 * tmax))
    a = coverage(u, v, sharpness, ok, band) * shadow_t_ramp(t, tmax) * det_gate(cos_dn)
    return transmittance(a).reshape(rays.shape)


def soft_occlusion_brute(rays: Rays, tris: Triangles, sharpness: float,
                         band: float = 0.08, t_min: float = DEFAULT_T_MIN,
                         t_max=T_MAX) -> torch.Tensor:
    """Soft visibility of each shadow segment: the product over every
    extended occluder of (1 - alpha), testing all triangles (the oracle);
    t_max a scalar or per ray (the distance to the light)."""
    o = rays.o.reshape(-1, 1, 3)
    d = rays.d.reshape(-1, 1, 3)
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    tmax = tm.reshape(-1, 1).expand(o.shape[:2]) if tm.ndim > 0 else tm
    t, u, v, ok, gate = _extended_tuv(o, d, tris, band, t_min, 2.0 * tmax)
    a = coverage(u, v, sharpness, ok, band) * shadow_t_ramp(t, tmax) * gate
    return transmittance(a).reshape(rays.shape)


def dot3(a, b):
    """Dot of two component-list vectors (3 tensors each)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    """Cross of two component-list vectors -> component list."""
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def soft_occlusion_layers_soa(o_c, d_c, t_max, ids, table, sharpness,
                              band: float = 0.08, t_min: float = DEFAULT_T_MIN):
    """Soft transmittance of every layer's shadow segment from one shared
    candidate list, ray index last.

    o_c: 3 x (K, 1, 1, R) surface origins; d_c: 3 x (K, L, 1, R) unit
    directions; t_max: (K, L, 1, R) segment lengths; ids: (L, C, R) int32
    candidates (-1 padding, no gradient); table: the (T, 15) tri_table, of
    which only the 9 geometry columns are gathered.  Returns (K, L, R)."""
    row = gather_verts(table[:, :9], ids.clamp_min(0))  # (L, C, R, 9)
    c = [row[..., i][None] for i in range(9)]           # 9 x (1, L, C, R)
    v0, e1, e2 = c[0:3], c[3:6], c[6:9]
    nrm = cross3(e1, e2)
    pv = cross3(d_c, e2)
    det = dot3(e1, pv)                                  # (K, L, C, R)
    inv = det / (det * det + DET_EPS)
    tv = [o_c[i] - v0[i] for i in range(3)]
    u = dot3(tv, pv) * inv
    qv = cross3(tv, e1)
    v = dot3(d_c, qv) * inv
    t = dot3(e2, qv) * inv
    cos_dn = det * torch.rsqrt(torch.clamp_min(dot3(d_c, d_c) * dot3(nrm, nrm), 1e-30))
    ok = ((ids[None] >= 0) & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
          & (u + v <= 1.0 + band) & (t > t_min) & (t < 2.0 * t_max))
    a = coverage(u, v, sharpness, ok, band) * shadow_t_ramp(t, t_max) * det_gate(cos_dn)
    return torch.prod(1.0 - a, dim=-2)                  # over C -> (K, L, R)


def soft_occlusion_layers(o, d, t_max, ids, table, sharpness, band: float = 0.08,
                          t_min: float = DEFAULT_T_MIN):
    """soft_occlusion_layers_soa in tpurt's ray-first layout: o (R, K, 3),
    d (R, K, L, 3), t_max (R, K, L), ids (R, L, C) -> transmittance
    (R, K, L)."""
    o_c = [o[..., i].T[:, None, None, :] for i in range(3)]
    d_c = [d[..., i].permute(1, 2, 0)[:, :, None, :] for i in range(3)]
    tm = t_max.permute(1, 2, 0)[:, :, None, :]
    vis = soft_occlusion_layers_soa(o_c, d_c, tm, ids.permute(1, 2, 0), table,
                                    sharpness, band, t_min)
    return vis.permute(2, 0, 1)
