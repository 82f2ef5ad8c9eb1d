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
from tpurt_torch.diff.gather_grad import accumulate_rows, gather_verts
from tpurt_torch.diff.intersect_vjp import intersect_tuv
from tpurt_torch.kernels import softocc

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


def soft_occlusion_layers_plain(o_c, d_c, t_max, ids, table, sharpness,
                                band: float = 0.08, t_min: float = DEFAULT_T_MIN):
    """soft_occlusion_layers_soa as a composition of torch operations over
    (K, L, C, R) tensors, differentiated by autograd: its route for CPU
    tensors, and the plain version the CUDA kernels are held to."""
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


def _dsmooth01(x):
    """Derivative of _smoothstep01."""
    return 6.0 * x * (1.0 - x)


def _in01(x):
    """Where torch.clamp(x, 0, 1) passes its gradient."""
    return (x >= 0.0) & (x <= 1.0)


def _min_grad(a, b, g):
    """torch.minimum(a, b)'s backward: g to the smaller, half each on a tie."""
    half = torch.where(a == b, 0.5 * g, g)
    return torch.where(a > b, 0.0, half), torch.where(a < b, 0.0, half)


def soft_occlusion_layers_vjp(o, d, t_max, ids, table, sharpness: float, band: float,
                              t_min: float, g: torch.Tensor):
    """The backward of soft_occlusion_layers_soa as csrc/softocc.cu's
    backward kernel computes it, in whole-tensor torch operations (its
    plain version): o 3 x (K, R), d 3 x (K, L, R), t_max (K, L, R), ids (L,
    C, R), g the (K, L, R) cotangent of the transmittance.  Nothing of the
    forward is kept: a is recomputed, d vis / d a_c is g times the product
    of the other candidates' (1 - a), the exclusive prefix times the
    exclusive suffix product (no division, so 1 - a = 0 stays exact), and
    the chain runs back through coverage, ramp, gate and Moller-Trumbore
    by hand.  Returns (go 3 x (K, R) summed over L and C, gd 3 x (K, L, R)
    and gt_max (K, L, R) summed over C, rows (L, C, R, 9): each candidate's
    table cotangent (v0, e1, e2) summed over K, 0 for a -1 id)."""
    ids = ids.detach()
    row = table.detach()[:, :9][ids.clamp_min(0).long()]  # (L, C, R, 9)
    cr = [row[..., i][None] for i in range(9)]           # 9 x (1, L, C, R)
    v0, e1, e2 = cr[0:3], cr[3:6], cr[6:9]
    oc = [x.detach()[:, None, None, :] for x in o]        # (K, 1, 1, R)
    dc = [x.detach()[:, :, None, :] for x in d]           # (K, L, 1, R)
    tm = t_max.detach()[:, :, None, :]
    # the forward, every intermediate kept
    nrm = cross3(e1, e2)
    pv = cross3(dc, e2)
    det = dot3(e1, pv)
    den = det * det + DET_EPS
    inv = det / den
    tv = [oc[i] - v0[i] for i in range(3)]
    uu, qv = dot3(tv, pv), cross3(tv, e1)
    vv, tt = dot3(dc, qv), dot3(e2, qv)
    u, v, t = uu * inv, vv * inv, tt * inv
    dd, nn = dot3(dc, dc), dot3(nrm, nrm)
    q = dd * nn
    rs = torch.rsqrt(torch.clamp_min(q, 1e-30))
    cos_dn = det * rs
    ok = ((ids[None] >= 0) & (det.abs() > DET_EPS) & (u >= -band) & (v >= -band)
          & (u + v <= 1.0 + band) & (t > t_min) & (t < 2.0 * tm))
    w3 = 1.0 - u - v
    m1 = torch.minimum(u, v)
    s = torch.minimum(m1, w3)
    sig = torch.sigmoid(sharpness * s)
    use_band = bool(band and band > 0.0)
    if use_band:
        wr = (s + band) / (0.5 * band)
        wc = torch.clamp(wr, 0.0, 1.0)
        win = _smoothstep01(wc)
    else:
        win = torch.ones_like(sig)
    cov = torch.where(ok, sig * win, 0.0)
    tmc = torch.clamp_min(tm, 1e-12)
    x = t / tmc
    ur = (x - RAMP_NEAR0) / (RAMP_NEAR1 - RAMP_NEAR0)
    dr = (RAMP_FAR1 - x) / (RAMP_FAR1 - RAMP_FAR0)
    uc, dcl = torch.clamp(ur, 0.0, 1.0), torch.clamp(dr, 0.0, 1.0)
    su, sd = _smoothstep01(uc), _smoothstep01(dcl)
    ramp = su * sd
    gr = (cos_dn.abs() - DET_GATE_LO) / (DET_GATE_HI - DET_GATE_LO)
    gc = torch.clamp(gr, 0.0, 1.0)
    gate = _smoothstep01(gc)
    crm = cov * ramp
    om = 1.0 - crm * gate                                 # (K, L, C, R)
    # d vis / d a_c: the exclusive prefix and suffix products over C
    ones = torch.ones_like(om[..., :1, :])
    pre = torch.cumprod(torch.cat([ones, om[..., :-1, :]], dim=-2), dim=-2)
    suf = torch.cumprod(torch.cat([ones, om.flip(-2)[..., :-1, :]], dim=-2), dim=-2).flip(-2)
    ga = torch.where(ok, -(g[:, :, None, :] * (pre * suf)), 0.0)
    # a = (cov * ramp) * gate
    g_cr, g_gate = ga * gate, ga * crm
    g_cov, g_ramp = g_cr * ramp, g_cr * cov
    # coverage
    g_s = g_cov * win * (1.0 - sig) * sig * sharpness
    if use_band:
        g_s = g_s + torch.where(_in01(wr), g_cov * sig * _dsmooth01(wc), 0.0) / (0.5 * band)
    g_m1, g_w3 = _min_grad(m1, w3, g_s)
    g_u, g_v = _min_grad(u, v, g_m1)
    g_u, g_v = g_u - g_w3, g_v - g_w3
    # ramp
    g_x = (torch.where(_in01(ur), g_ramp * sd * _dsmooth01(uc), 0.0) / (RAMP_NEAR1 - RAMP_NEAR0)
           - torch.where(_in01(dr), g_ramp * su * _dsmooth01(dcl), 0.0)
           / (RAMP_FAR1 - RAMP_FAR0))
    g_t = g_x / tmc
    g_tm = torch.where(tm >= 1e-12, -g_x * t / (tmc * tmc), 0.0)
    # gate
    g_cos = torch.where(_in01(gr), g_gate * _dsmooth01(gc), 0.0) \
        / (DET_GATE_HI - DET_GATE_LO) * torch.sign(cos_dn)
    # cos_dn = det * rsqrt(max(dd * nn, 1e-30))
    g_q = torch.where(q >= 1e-30, -0.5 * (g_cos * det) * rs * rs * rs, 0.0)
    g_dd, g_nn = g_q * nn, g_q * dd
    # (u, v, t) = (uu, vv, tt) * inv, inv = det / (det * det + eps)
    g_inv = g_u * uu + g_v * vv + g_t * tt
    g_uu, g_vv, g_tt = g_u * inv, g_v * inv, g_t * inv
    g_det = g_cos * rs + g_inv / den - g_inv * inv / den * 2.0 * det

    def axpy(a, x, *terms):  # component lists: a * x + terms
        out = [a * xi for xi in x]
        for y in terms:
            out = [oi + yi for oi, yi in zip(out, y)]
        return out

    g_nrm = axpy(2.0 * g_nn, nrm)
    g_pv = axpy(g_det, e1, axpy(g_uu, tv))
    g_qv = axpy(g_vv, dc, axpy(g_tt, e2))
    g_tv = axpy(g_uu, pv, cross3(e1, g_qv))                        # qv = tv x e1
    g_d = axpy(2.0 * g_dd, dc, axpy(g_vv, qv), cross3(e2, g_pv))    # pv = d x e2
    g_e1 = axpy(g_det, pv, cross3(g_qv, tv), cross3(e2, g_nrm))     # nrm = e1 x e2
    g_e2 = axpy(g_tt, qv, cross3(g_pv, dc), cross3(g_nrm, e1))
    go = [x.sum(dim=(1, 2)) for x in g_tv]                          # tv = o - v0
    gd = [x.sum(dim=2) for x in g_d]
    rows = torch.stack([-x for x in g_tv] + g_e1 + g_e2, dim=-1).sum(dim=0)
    return go, gd, g_tm.sum(dim=2), rows


class SoftOcclusion(torch.autograd.Function):
    """soft_occlusion_layers_soa as one autograd node over compact inputs:
    o 3 x (K, R), d 3 x (K, L, R), t_max (K, L, R), ids (L, C, R), table
    (T, W).  It saves only those inputs.  CUDA tensors go through
    csrc/softocc.cu's forward and backward kernels (kernels/softocc.py),
    CPU tensors through the plain composition and
    soft_occlusion_layers_vjp; the candidates' rows are summed into the
    table by the gather backward (diff/gather_grad.py accumulate_rows,
    segsum by default)."""

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, t_max, ids, table, sharpness, band, t_min):
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, t_max, ids, table)
        ctx.consts = (sharpness, band, t_min)
        if t_max.device.type == "cuda":
            return softocc.forward([ox, oy, oz], [dx, dy, dz], t_max, ids, table,
                                   sharpness, band, t_min)
        return soft_occlusion_layers_plain(
            [x[:, None, None, :] for x in (ox, oy, oz)],
            [x[:, :, None, :] for x in (dx, dy, dz)], t_max[:, :, None, :], ids, table,
            sharpness, band, t_min)

    @staticmethod
    def backward(ctx, g):
        ox, oy, oz, dx, dy, dz, t_max, ids, table = ctx.saved_tensors
        args = ([ox, oy, oz], [dx, dy, dz], t_max, ids, table, *ctx.consts)
        if t_max.device.type == "cuda":
            go, gd, g_tm, rows = softocc.backward(*args, g)
        else:
            go, gd, g_tm, rows = soft_occlusion_layers_vjp(*args, g)
        g_table = None
        if ctx.needs_input_grad[8]:
            g_table = accumulate_rows(ids.clamp_min(0).reshape(-1).long(),
                                      rows.reshape(-1, 9), table.shape[0], table.shape[1])
        return (*go, *gd, g_tm, None, g_table, None, None, None)


def soft_occlusion_layers_soa(o_c, d_c, t_max, ids, table, sharpness,
                              band: float = 0.08, t_min: float = DEFAULT_T_MIN):
    """Soft transmittance of every layer's shadow segment from one shared
    candidate list, ray index last.

    o_c: 3 x (K, 1, 1, R) surface origins; d_c: 3 x (K, L, 1, R) unit
    directions; t_max: (K, L, 1, R) segment lengths; ids: (L, C, R) int32
    candidates (-1 padding, no gradient); table: the (T, 15) tri_table, of
    which only the 9 geometry columns are read.  Returns (K, L, R).

    CPU tensors take soft_occlusion_layers_plain (autograd through the
    composition); CUDA tensors the SoftOcclusion node, whose forward and
    backward are one kernel each, or the call raises."""
    dev = t_max.device
    if dev.type == "cpu":
        return soft_occlusion_layers_plain(o_c, d_c, t_max, ids, table, sharpness, band,
                                           t_min)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k, n_l, _, r = d_c[0].shape
    return SoftOcclusion.apply(*(x.reshape(k, r) for x in o_c),
                               *(x.reshape(k, n_l, r) for x in d_c), t_max.reshape(k, n_l, r),
                               ids.detach(), table, sharpness, band, t_min)


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
