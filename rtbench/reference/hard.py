"""The plain reference of a hard frame: for each ray, the nearest
Möller–Trumbore hit, one shadow ray a point light, Lambert shading, and
with emitter samples the Monte-Carlo area-light estimate; a missed ray
gets the background.

It reads only the frozen scene arrays and the rays (and, for area light,
the seed each frame's emitter samples were drawn from), and works out
again everything the port derives from them: the tree (``lbvh.py``), the
triangles' edges and normals, and the emitter samples.  Conventions, as
the port states them: shadow rays start 1e-3 along the face-forward
normal and stop at 0.999 of the distance to the light; hits count for t
above 1e-4; light falls off as 1/r^2 (r^2 at least 1e-8); a sample point
is drawn on the emitters by area x mean radiance, by the sqrt(r)
barycentric warp, from ``torch.rand`` of a float64 (4,) then a float32
(4, 2) on the card.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from rtbench.reference import lbvh

T_MIN = 1e-4
T_FAR = 1e30
SHADOW_EPS = 1e-3
SHADOW_T_FRAC = 1.0 - 1e-3
INV_PI = 1.0 / math.pi


@dataclass
class RefScene:
    tree: lbvh.Tree
    v0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    light_pos: torch.Tensor
    light_intensity: torch.Tensor
    background: torch.Tensor
    ambient: torch.Tensor

    @classmethod
    def from_arrays(cls, arrays, device) -> "RefScene":
        def t(x):
            return torch.as_tensor(np.asarray(x), device=device)
        v0, v1, v2 = corners(arrays, device)
        tree = lbvh.build(*lbvh.tri_boxes(v0, v1, v2))
        return cls(tree=tree, v0=v0, e1=v1 - v0, e2=v2 - v0, albedo=t(arrays.albedo),
                   emission=t(arrays.emission), light_pos=t(arrays.light_pos),
                   light_intensity=t(arrays.light_intensity),
                   background=t(arrays.background), ambient=t(arrays.ambient))

    def cast(self, dtype) -> "RefScene":
        return RefScene(self.tree.to(dtype), *(x.to(dtype) for x in (
            self.v0, self.e1, self.e2, self.albedo, self.emission, self.light_pos,
            self.light_intensity, self.background, self.ambient)))

    @property
    def tris(self) -> tuple:
        return self.v0, self.e1, self.e2


def corners(arrays, device) -> tuple:
    """Each triangle's three corners (T, 3) f32, from the frozen arrays."""
    verts = torch.as_tensor(arrays.verts, device=device)
    faces = torch.as_tensor(arrays.faces, device=device).long()
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(a, floor):
    return a / torch.sqrt(torch.clamp_min(_dot(a, a), floor))[..., None]


class EmitterSampler:
    """The emitter samples a frame draws, worked out again from the frame's
    seed: faces by area x mean radiance (an inverse CDF in float64),
    points by the sqrt(r) warp, with their unit normals, radiance and
    area-measure pdf."""

    def __init__(self, arrays, device):
        self.v0, self.v1, self.v2 = corners(arrays, device)
        self.emission = torch.as_tensor(arrays.emission, device=device)
        n = lbvh._cross(self.v1 - self.v0, self.v2 - self.v0)
        area = 0.5 * torch.sqrt(torch.clamp_min(_dot(n, n), 1e-30))
        w = area * self.emission.mean(-1)
        total = w.sum()
        self.any = bool(total > 0)
        self.probs = w / torch.clamp_min(total, 1e-30) if self.any else torch.zeros_like(w)
        self.cdf = torch.cumsum((self.probs if self.any else torch.ones_like(w)).double(), 0)
        self.area, self.normal = area, n

    def draw(self, seed: int, count: int):
        """(points (S, 3), unit normals (S, 3), radiance (S, 3), pdf (S,))."""
        dev = self.cdf.device
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        u = torch.rand(count, generator=g, device=dev, dtype=torch.float64)
        face = torch.searchsorted(self.cdf, u * self.cdf[-1], right=True)
        face = face.clamp_max(self.cdf.shape[0] - 1)
        r = torch.rand((count, 2), generator=g, device=dev, dtype=torch.float32)
        su = torch.sqrt(r[:, 0:1])
        b0 = 1.0 - su
        b1 = r[:, 1:2] * su
        b2 = 1.0 - b0 - b1
        p = b0 * self.v0[face] + b1 * self.v1[face] + b2 * self.v2[face]
        nl = _unit(self.normal[face], 1e-30)
        pdf = self.probs[face] / torch.clamp_min(self.area[face], 1e-30)
        return p, nl, self.emission[face], pdf


def shade(ref: RefScene, o: torch.Tensor, d: torch.Tensor, samples=None,
          count: bool = False):
    """Radiance (R, 3) of rays o, d (R, 3) in the dtype of `ref` (cast to
    float32 on return).  samples: per-ray emitter samples (points,
    normals, radiance: (R, S, 3); pdf (R, S)) or None.  With count, also
    the walks' (box tests, triangle tests) summed over the rays."""
    dt = ref.v0.dtype
    o, d = o.to(dt), d.to(dt)
    r = o.shape[0]
    far = torch.full((r,), T_FAR, dtype=dt, device=o.device)
    hit = lbvh.walk(ref.tree, ref.tris, o, d, far, T_MIN, any_hit=False)
    work = [hit.box_tests.sum(), hit.tri_tests.sum()]
    valid = hit.tri >= 0
    tid = hit.tri.clamp_min(0)
    p = o + torch.where(valid, hit.t, torch.zeros_like(hit.t))[:, None] * d
    n = _unit(lbvh._cross(ref.e1[tid], ref.e2[tid]), 1e-30)
    n = torch.where((_dot(n, d) > 0)[:, None], -n, n)
    albedo, emission = ref.albedo[tid], ref.emission[tid]
    o_surf = p + SHADOW_EPS * n

    def visible(direction, length):
        t_max = torch.where(valid, length * SHADOW_T_FRAC, torch.zeros_like(length))
        w = lbvh.walk(ref.tree, ref.tris, o_surf, direction, t_max, T_MIN, any_hit=True)
        work[0] = work[0] + w.box_tests.sum()
        work[1] = work[1] + w.tri_tests.sum()
        return (~w.blocked).to(dt)

    direct = torch.zeros_like(p)
    for pos, inten in zip(ref.light_pos, ref.light_intensity):
        delta = pos[None] - p
        dist = torch.sqrt(torch.clamp_min(_dot(delta, delta), 1e-12))
        wi = delta / dist[:, None]
        falloff = inten[None] / torch.clamp_min(dist * dist, 1e-8)[:, None]
        ndotl = torch.clamp_min(_dot(wi, n), 0.0)
        direct = direct + falloff * (ndotl * visible(wi, dist))[:, None]
    color = emission + albedo * (INV_PI * direct + ref.ambient[None])
    if samples is not None:
        lp, ln, le, pdf = (x.to(dt) for x in samples)
        acc = torch.zeros_like(p)
        for s in range(lp.shape[1]):
            delta = lp[:, s] - p
            r2 = torch.clamp_min(_dot(delta, delta), 1e-8)
            wi = delta / torch.sqrt(r2)[:, None]
            cos_s = torch.clamp_min(_dot(wi, n), 0.0)
            cos_l = _dot(wi, ln[:, s]).abs()
            dl = lp[:, s] - o_surf
            ldist = torch.sqrt(torch.clamp_min(_dot(dl, dl), 1e-12))
            vis = visible(dl / ldist[:, None], ldist)
            g = cos_s * cos_l / r2 * vis / torch.clamp_min(pdf[:, s], 1e-30)
            g = torch.where(pdf[:, s] > 0, g, torch.zeros_like(g))
            acc = acc + g[:, None] * le[:, s]
        color = color + albedo * INV_PI * (acc / lp.shape[1])
    out = torch.where(valid[:, None], color, ref.background[None].expand_as(color)).float()
    if count:
        return out, (int(work[0]), int(work[1]))
    return out


def off_frac(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """The share of rays whose radiance differs from the reference's by
    more than atol + rtol |want| in some channel (a non-finite value
    counts as off)."""
    bad = ~((got - want).abs() <= atol + rtol * want.abs()).all(-1)
    return float(bad.float().mean()) if bad.numel() else 1.0
