"""The plain reference of the inverse-rendering fit: the soft K-layer render
with soft visibility, the loss, its gradient to vertices and albedo, and
Adam's update, followed step by step from the frozen start.

Semantics, as the port states them (``render/pipeline.py``,
``diff/softvis.py``, ``api/inverse.py``), written again here in plain torch
and plain autograd:

- each ray's K nearest extended hits, sorted by (t, id): |det| > 1e-12,
  u, v >= -band, u + v <= 1 + band, 1e-4 < t < t_max, with the smooth
  inverse det / (det^2 + 1e-12); a hit's attributes come from the
  triangle table [v0, e1, e2, albedo, emission] at the parameters;
- coverage sigmoid(sharpness s) times a window that is 0 at s <= -band
  and 1 at s >= -band/2 (s the signed barycentric distance to the nearest
  edge), times a grazing gate on |cos(ray, normal)| over [2e-3, 2e-2];
- toward each light, the k_occ nearest candidates of the layer-0 point's
  segment (from the point offset 1e-3 along its face-forward normal, up
  to twice 0.999 of the distance), shared by every layer; each layer's
  transmittance the product over them of 1 - coverage x a ramp in t over
  [0.004, 0.04] and [0.96, 0.996] of its own segment x the gate;
- Lambert shading with 1/r^2 falloff and ambient, front-to-back
  compositing over the background;
- loss: the sum over pixels of the squared error to the target; albedo
  clamped to [0, 1] before the table; Adam (0.9, 0.999, 1e-8).

The candidate lists come from this package's own tree (``lbvh.py``) over
each triangle's whole band region (the box of the band triangle's
corners), so no band hit is culled by a box.
"""

from __future__ import annotations

import math

import torch

from rtbench.reference import lbvh

T_MIN = 1e-4
T_FAR = 1e30
DET_EPS = 1e-12
SHADOW_EPS = 1e-3
SHADOW_T_FRAC = 1.0 - 1e-3
INV_PI = 1.0 / math.pi
GATE_LO, GATE_HI = 2e-3, 2e-2
RAMP = (0.004, 0.04, 0.96, 0.996)
BIG_ID = 1 << 40


def band_tree(table: torch.Tensor, band: float) -> lbvh.Tree:
    """The tree over the band triangles: each leaf's box is the box of the
    corners at (u, v) = (-b, -b), (1 + 2b, -b), (-b, 1 + 2b)."""
    v0, e1, e2 = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    c0 = v0 - band * (e1 + e2)
    c1 = v0 + (1 + 2 * band) * e1 - band * e2
    c2 = v0 - band * e1 + (1 + 2 * band) * e2
    return lbvh.build(*lbvh.tri_boxes(c0, c1, c2))


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def band_test(o, d, v0, e1, e2, band, t_max):
    """(t, accepted) of the extended Möller–Trumbore test."""
    pv = _cross(d, e2)
    det = _dot(e1, pv)
    inv = det / (det * det + DET_EPS)
    tv = o - v0
    u = _dot(tv, pv) * inv
    qv = _cross(tv, e1)
    v = _dot(d, qv) * inv
    t = _dot(e2, qv) * inv
    ok = ((det.abs() > DET_EPS) & (u >= -band) & (v >= -band) & (u + v <= 1.0 + band)
          & (t > T_MIN) & (t < t_max))
    return t, ok


@torch.no_grad()
def k_nearest(tree: lbvh.Tree, table: torch.Tensor, o, d, k: int, band: float,
              t_max: torch.Tensor) -> torch.Tensor:
    """(R, k) ids of each ray's k nearest band hits, sorted by (t, id), -1
    padded.  A lockstep stack walk, nearer child on top, each box culled
    against min(k-th t, t_max)."""
    r, dev = o.shape[0], o.device
    n = tree.num_leaves
    v0, e1, e2 = table[:, 0:3], table[:, 3:6], table[:, 6:9]
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    stack = torch.zeros((r, lbvh.STACK), dtype=torch.int64, device=dev)
    enter = torch.zeros((r, lbvh.STACK), dtype=o.dtype, device=dev)
    sp = (t_max > T_MIN).to(torch.int64)
    ts = torch.full((r, k), T_FAR, dtype=o.dtype, device=dev)
    ids = torch.full((r, k), BIG_ID, dtype=torch.int64, device=dev)
    slots = torch.arange(k, device=dev)
    zero = torch.zeros((), dtype=o.dtype, device=dev)
    deepest = torch.zeros((), dtype=torch.int64, device=dev)
    it = 0
    while True:
        if it % lbvh.CHECK_EVERY == 0 and not bool((sp > 0).any()):
            break
        it += 1
        upper = torch.minimum(ts[:, -1], t_max)
        active = sp > 0
        top = (sp - 1).clamp_min(0)[:, None]
        node = stack.gather(1, top)[:, 0]
        ent = enter.gather(1, top)[:, 0]
        sp = sp - active.to(torch.int64)
        live = active & (ent <= upper)
        leaf = node >= n - 1
        if n > 1:
            inner = live & ~leaf
            c = node.clamp_max(n - 2)
            kids = (tree.left[c], tree.right[c])
            tn, hit = [], []
            for kid in kids:
                t0 = (tree.lo[kid] - o) * inv
                t1 = (tree.hi[kid] - o) * inv
                a = torch.maximum(torch.minimum(t0, t1).amax(-1), zero)
                b = torch.minimum(torch.maximum(t0, t1).amin(-1), upper)
                tn.append(a)
                hit.append(inner & (a <= b))
            near_left = tn[0] <= tn[1]
            both = hit[0] & hit[1]
            first = torch.where(both, torch.where(near_left, kids[1], kids[0]),
                                torch.where(hit[0], kids[0], kids[1]))
            first_t = torch.where(both, torch.where(near_left, tn[1], tn[0]),
                                  torch.where(hit[0], tn[0], tn[1]))
            second = torch.where(near_left, kids[0], kids[1])
            second_t = torch.where(near_left, tn[0], tn[1])
            at0 = sp.clamp_max(lbvh.STACK - 1)[:, None]
            at1 = (sp + 1).clamp_max(lbvh.STACK - 1)[:, None]
            stack.scatter_(1, at0, first[:, None])
            enter.scatter_(1, at0, first_t[:, None])
            stack.scatter_(1, at1, second[:, None])
            enter.scatter_(1, at1, second_t[:, None])
            sp = sp + hit[0].to(torch.int64) + hit[1].to(torch.int64)
            deepest = torch.maximum(deepest, sp.max())
        tid = tree.order[(node - (n - 1)).clamp(0, n - 1)]
        t, ok = band_test(o, d, v0[tid], e1[tid], e2[tid], band, t_max)
        ok = ok & live & leaf
        t = torch.where(ok, t, torch.full_like(t, T_FAR))
        key_id = torch.where(ok, tid, torch.full_like(tid, BIG_ID))
        before = (ts < t[:, None]) | ((ts == t[:, None]) & (ids < key_id[:, None]))
        pos = before.sum(1, keepdim=True)
        prev = (slots[None] - 1).clamp_min(0).expand(r, k)
        ts = torch.where(slots < pos, ts, torch.where(slots == pos, t[:, None],
                                                        ts.gather(1, prev)))
        ids = torch.where(slots < pos, ids, torch.where(slots == pos, key_id[:, None],
                                                          ids.gather(1, prev)))
    if int(deepest) >= lbvh.STACK - 1:
        raise RuntimeError(f"reference walk stack overflow ({int(deepest)} of {lbvh.STACK})")
    return torch.where(ids == BIG_ID, -1, ids)


def _smooth01(x):
    return x * x * (3.0 - 2.0 * x)


def coverage(u, v, sharpness, valid, band):
    s = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    a = torch.sigmoid(sharpness * s) * _smooth01(torch.clamp((s + band) / (0.5 * band), 0, 1))
    return torch.where(valid, a, torch.zeros_like(a))


def gate(cos_dn):
    return _smooth01(torch.clamp((cos_dn.abs() - GATE_LO) / (GATE_HI - GATE_LO), 0, 1))


def ramp(t, t_max):
    x = t / torch.clamp_min(t_max, 1e-12)
    up = torch.clamp((x - RAMP[0]) / (RAMP[1] - RAMP[0]), 0, 1)
    dn = torch.clamp((RAMP[3] - x) / (RAMP[3] - RAMP[2]), 0, 1)
    return _smooth01(up) * _smooth01(dn)


def _surface(table, o, d, ids, sharp, band):
    """Each layer's hit point, face-forward normal, shadow origin, albedo,
    emission and coverage, from the table rows of ids (R, K)."""
    valid = ids >= 0
    row = table[ids.clamp_min(0)]                                              # (R, K, 15)
    v0, e1, e2, alb, emi = (row[..., i:i + 3] for i in (0, 3, 6, 9, 12))
    oo, dd = o[:, None], d[:, None]
    pv = _cross(dd, e2)
    det = _dot(e1, pv)
    inv = det / (det * det + DET_EPS)
    tv = oo - v0
    u = _dot(tv, pv) * inv
    qv = _cross(tv, e1)
    v = _dot(dd, qv) * inv
    t = _dot(e2, qv) * inv
    nr = _cross(e1, e2)
    inv_n = torch.rsqrt(torch.clamp_min(_dot(nr, nr), 1e-40))
    inv_d = torch.rsqrt(torch.clamp_min(_dot(dd, dd), 1e-40))
    flip = torch.where(_dot(nr, dd) > 0, -inv_n, inv_n)
    n = nr * flip[..., None]
    p = oo + t[..., None] * dd
    alpha = coverage(u, v, sharp, valid, band) * gate(det * inv_n * inv_d)
    return dict(valid=valid, p=p, n=n, o_surf=p + SHADOW_EPS * n, albedo=alb, emission=emi,
                alpha=alpha)


def _to_light(surf, lpos):
    delta = lpos - surf["p"]
    dist = torch.sqrt(torch.clamp_min(_dot(delta, delta), 1e-12))               # (R, K)
    return delta / dist[..., None], dist


@torch.no_grad()
def candidates(table, tree, o, d, scene, soft: dict):
    """The discrete part of the soft render: each ray's layer ids (R, K)
    and, for each light, the candidate occluders (R, C) of its layer-0
    segment."""
    far = torch.full((o.shape[0],), T_FAR, dtype=o.dtype, device=o.device)
    ids = k_nearest(tree, table, o, d, soft["k_layers"], soft["band"], far)
    surf = _surface(table, o, d, ids, soft["sharpness"], soft["band"])
    occ = []
    for lpos in scene["light_pos"]:
        wi, dist = _to_light(surf, lpos)
        seg = torch.where(surf["valid"][:, 0], dist[:, 0], torch.zeros_like(dist[:, 0]))
        occ.append(k_nearest(tree, table, surf["o_surf"][:, 0], wi[:, 0], soft["k_occ"],
                             soft["band"], 2.0 * seg * SHADOW_T_FRAC))
    return ids, occ


def soft_colors(table, o, d, ids, occ, scene, soft: dict) -> torch.Tensor:
    """Radiance (R, 3) of rays o, d through the soft render, differentiable
    in `table` (T, 15), from the candidates() of the same rays.  scene:
    light_pos, light_intensity (L, 3), background, ambient (3,); soft:
    k_layers, sharpness, band, k_occ."""
    band, sharp = soft["band"], soft["sharpness"]
    surf = _surface(table, o, d, ids, sharp, band)
    direct = torch.zeros_like(surf["p"])
    for lpos, inten, cand in zip(scene["light_pos"], scene["light_intensity"], occ):
        wi, dist = _to_light(surf, lpos)
        g = table[cand.clamp_min(0), :9][:, None]                                # (R, 1, C, 9)
        c0, c1, c2 = g[..., 0:3], g[..., 3:6], g[..., 6:9]
        so, sd = surf["o_surf"][:, :, None], wi[:, :, None]                      # (R, K, 1, 3)
        tmax = (dist * SHADOW_T_FRAC)[..., None]                                 # (R, K, 1)
        nrm = _cross(c1, c2)
        pv = _cross(sd, c2)
        det = _dot(c1, pv)
        inv = det / (det * det + DET_EPS)
        tv = so - c0
        uu = _dot(tv, pv) * inv
        qv = _cross(tv, c1)
        vv = _dot(sd, qv) * inv
        tt = _dot(c2, qv) * inv
        cos_dn = det * torch.rsqrt(torch.clamp_min(_dot(sd, sd) * _dot(nrm, nrm), 1e-30))
        ok = ((cand[:, None] >= 0) & (det.abs() > DET_EPS) & (uu >= -band) & (vv >= -band)
              & (uu + vv <= 1.0 + band) & (tt > T_MIN) & (tt < 2.0 * tmax))
        a = coverage(uu, vv, sharp, ok, band) * ramp(tt, tmax) * gate(cos_dn)
        vis = torch.prod(1.0 - a, dim=-1)                                        # (R, K)
        falloff = inten / torch.clamp_min(dist * dist, 1e-8)[..., None]
        ndotl = torch.clamp_min(_dot(wi, surf["n"]), 0.0)
        direct = direct + falloff * (ndotl * vis)[..., None]
    color = surf["emission"] + surf["albedo"] * (INV_PI * direct + scene["ambient"])
    color = torch.where(surf["valid"][..., None], color, torch.zeros_like(color))
    alpha = surf["alpha"]
    trans = torch.cumprod(1.0 - alpha, dim=-1)
    before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    out = ((alpha * before)[..., None] * color).sum(1)
    return out + trans[:, -1:] * scene["background"]


def make_table(verts, faces, albedo, emission) -> torch.Tensor:
    f = faces.long()
    v0, v1, v2 = verts[f[:, 0]], verts[f[:, 1]], verts[f[:, 2]]
    return torch.cat([v0, v1 - v0, v2 - v0, albedo.clamp(0.0, 1.0), emission], dim=-1)


def follow(start: dict, faces, emission, scene: dict, o, d, target, soft: dict,
           steps: int, chunks: int, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
           dtype=torch.float32) -> dict:
    """The fit's first `steps` steps from `start` ({"verts", "albedo"}):
    the loss of each (over the pixel count), each leaf's first gradient and
    its change after the steps.  Computed in `dtype` (float32; bfloat16 for
    the control)."""
    params = {k: v.detach().to(dtype).clone().requires_grad_(True) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    cast = {k: (v.to(dtype) if torch.is_tensor(v) else v) for k, v in scene.items()}
    o, d, target = o.to(dtype), d.to(dtype), target.to(dtype)
    n = o.shape[0]
    losses, grad1 = [], None
    for step in range(1, steps + 1):
        table = make_table(params["verts"], faces, params["albedo"], emission.to(dtype))
        leaf = table.detach().requires_grad_(True)
        tree = band_tree(leaf.detach().float(), soft["band"]).to(dtype)
        ids, occ = candidates(leaf.detach(), tree, o, d, cast, soft)
        total = torch.zeros((), dtype=torch.float64, device=o.device)
        acc = torch.zeros_like(leaf)
        for c, rows in enumerate(torch.arange(n, device=o.device).chunk(chunks)):
            colors = soft_colors(leaf, o[rows], d[rows], ids[rows], [x[rows] for x in occ],
                                 cast, soft)
            loss = ((colors - target[rows]) ** 2).sum()
            acc += torch.autograd.grad(loss, leaf)[0]
            total += loss.detach().double()
        for p in params.values():
            p.grad = None
        table.backward(acc)
        losses.append(float(total) / n)
        with torch.no_grad():
            for k, p in params.items():
                g = p.grad
                m[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                s[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                m_hat = m[k] / (1 - betas[0] ** step)
                s_hat = s[k] / (1 - betas[1] ** step)
                p -= lr * m_hat / (s_hat.sqrt() + eps)
            if step == 1:
                grad1 = {k: float(p.grad.double().norm()) for k, p in params.items()}
    change = {k: float((params[k].detach().double() - start[k].double()).norm())
              for k in params}
    return {"losses": losses, "grad1": grad1, "change": change}
