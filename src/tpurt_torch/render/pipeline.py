"""Hard render pipeline: primary rays -> closest hits -> shadow rays ->
Lambert shading (counterpart of ``tpurt/render/pipeline.py``, hard path).

Engines (``Tracer.method``):
- ``"brute"``: the O(rays x triangles) oracle (accel/intersect.py);
- ``"wide8"``: the 8-wide BVH walk (kernels/traverse8.py), the counterpart
  of tpurt's ``"pallas8"``: CUDA kernels on the GPU, their plain-torch twins
  on the CPU.

The soft (differentiable K-layer) render, area-light sampling and
multi-sample rendering are not ported yet; asking for them raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpurt_torch.accel.bvh8 import WideBVH, build_wide
from tpurt_torch.accel.intersect import intersect_brute, intersect_tuv, occluded_brute
from tpurt_torch.accel.lbvh import BVH, build_lbvh
from tpurt_torch.core.geometry import Camera, Hit, Rays
from tpurt_torch.core.math import cross
from tpurt_torch.core.scene import Scene
from tpurt_torch.kernels.traverse8 import occluded_wide8, traverse_wide8
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm
from tpurt_torch.render.shade import face_forward, light_dirs, shade_lambert

SHADOW_EPS = 1e-3  # offset shadow-ray origins off the surface
SHADOW_T_FRAC = 1.0 - 1e-3  # stop shadow rays just before the light
METHODS = ("brute", "wide8")


def _require_hard(soft: bool, light_samples: int, spp: int = 1) -> None:
    for asked, what, item in (
            (soft, "the soft render (soft=True)", "item 13"),
            (light_samples > 0, "area-light sampling (light_samples > 0)", "item 17"),
            (spp > 1, "multi-sample rendering (spp > 1)", "item 17")):
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to tpurt_torch yet (ROADMAP.md queue 1, "
                f"{item})")


def tri_table(tris) -> torch.Tensor:
    """Per-triangle (T, 15) f32 table [v0, e1, e2, albedo, emission].
    Forward only: its backward (tpurt's segment-sum gather) comes with the
    soft path."""
    v = tris.verts[tris.faces.long()]  # (T, 3 corners, 3)
    v0 = v[:, 0]
    return torch.cat([v0, v[:, 1] - v0, v[:, 2] - v0, tris.albedo,
                      tris.emission], dim=-1)


@dataclass
class Tracer:
    """Traversal engine bound to a scene.  ``table`` (brute only) must track
    ``scene.tris``."""

    scene: Scene
    bvh: BVH | None = None
    wide: WideBVH | None = None
    table: torch.Tensor | None = None
    method: str = "brute"

    def closest_shaded(self, rays: Rays) -> tuple[Hit, tuple | None]:
        """(Hit, shade) where shade = (albedo, emission, raw normal) of the
        winning triangle straight from the wide8 walk, or None for brute."""
        if self.method == "wide8":
            return traverse_wide8(rays, self.wide, shade_out=True)
        return intersect_brute(rays, self.scene.tris), None

    def visibility(self, rays: Rays, t_max: torch.Tensor) -> torch.Tensor:
        """Hard transmittance in (t_min, t_max): 1 visible, 0 occluded."""
        if self.method == "brute":
            occ = occluded_brute(rays, self.scene.tris, t_max=t_max)
        else:
            occ = occluded_wide8(rays, self.wide, t_max)
        return 1.0 - occ.to(torch.float32)


def make_tracer(scene: Scene, method: str = "brute") -> Tracer:
    """Build a Tracer for `scene` on the scene's device: the table for
    "brute", the LBVH and its 8-wide collapse for "wide8"."""
    if method == "brute":
        return Tracer(scene=scene, method=method, table=tri_table(scene.tris))
    if method != "wide8":
        raise ValueError(f"method {method!r} not in {METHODS}")
    bvh = build_lbvh(scene.tris)
    return Tracer(scene=scene, bvh=bvh, wide=build_wide(scene.tris, bvh),
                  method=method)


def _surface_attrs(rays: Rays, table: torch.Tensor, tri_id: torch.Tensor):
    """Hit point, face-forward unit normal, albedo and emission of the given
    triangles (one table row per ray; t recomputed by Möller–Trumbore).
    Callers mask invalid ids."""
    row = table[tri_id.clamp_min(0).long()]
    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    t, _, _, _ = intersect_tuv(rays.o, rays.d, v0, v0 + e1, v0 + e2)
    p = rays.o + t[..., None] * rays.d
    n_raw = cross(e1, e2)
    n = n_raw / torch.clamp_min(torch.linalg.norm(n_raw, dim=-1, keepdim=True),
                                1e-20)
    return p, face_forward(n, rays.d), row[..., 9:12], row[..., 12:15]


def hit_surface(tracer: Tracer, rays: Rays, hit: Hit, shade=None):
    """(p, n, albedo, emission) at each ray's closest hit.  shade: the
    kernel-emitted (albedo, emission, raw normal), which replaces the table
    lookup.  Values at missed rays are garbage; callers mask them."""
    if shade is None:
        return _surface_attrs(rays, tracer.table, hit.tri)
    albedo, emission, n_raw = shade
    t_eff = torch.where(hit.valid, hit.t, 1.0)  # a miss's T_MAX would overflow
    p = rays.o + t_eff[..., None] * rays.d
    n_len = torch.clamp_min(torch.linalg.norm(n_raw, dim=-1, keepdim=True), 1e-20)
    return p, face_forward(n_raw / n_len, rays.d), albedo, emission


def shadow_rays(scene: Scene, p: torch.Tensor, n: torch.Tensor,
                valid: torch.Tensor):
    """One shadow ray per (hit point, light), flattened light-major, with
    t_max just short of the light; a missed primary ray gets t_max = 0, so
    its shadow ray starts dead.  Returns (Rays (L*R, 3), t_max (L*R,))."""
    wi, dist, _ = light_dirs(p, scene.lights)
    L, R = scene.lights.pos.shape[0], p.shape[0]
    o_surf = p + SHADOW_EPS * n
    o_sh = o_surf[None].expand(L, R, 3).reshape(-1, 3)
    d_sh = wi.transpose(0, 1).reshape(-1, 3)
    t_sh = torch.where(valid[:, None], dist * SHADOW_T_FRAC, 0.0).T.reshape(-1)
    return Rays(o=o_sh, d=d_sh), t_sh


def _shade_layer(tracer: Tracer, rays: Rays, hit: Hit, shade=None):
    """Shade the closest-hit layer with hard shadow rays -> color (R, 3)."""
    scene = tracer.scene
    valid = hit.valid
    p, n, albedo, emission = hit_surface(tracer, rays, hit, shade)
    L, R = scene.lights.pos.shape[0], p.shape[0]
    if L > 0:
        sh_rays, t_sh = shadow_rays(scene, p, n, valid)
        vis = tracer.visibility(sh_rays, t_max=t_sh).reshape(L, R).T
    else:
        vis = torch.zeros((R, 0), dtype=torch.float32, device=p.device)
    color = shade_lambert(p, n, albedo, emission, scene.lights, vis,
                          scene.ambient)
    return torch.where(valid[..., None], color, 0.0)


def render_rays(tracer: Tracer, rays: Rays, *, soft: bool = False,
                light_samples: int = 0) -> torch.Tensor:
    """Radiance for a flat batch of rays -> (R, 3), hard render."""
    _require_hard(soft, light_samples)
    hit, shade = tracer.closest_shaded(rays)
    color = _shade_layer(tracer, rays, hit, shade)
    bg = tracer.scene.background.expand(color.shape)
    return torch.where(hit.valid[..., None], color, bg)


def render(scene: Scene, cam: Camera, *, method: str = "brute",
           tracer: Tracer | None = None, soft: bool = False, spp: int = 1,
           light_samples: int = 0) -> torch.Tensor:
    """Render an (H, W, 3) linear-radiance image on the scene's device.

    Primary rays are traced in Morton pixel order (neighbouring rays on
    neighbouring pixels) and the image is put back in row-major order; the
    per-ray engines give the same pixels in any order."""
    _require_hard(soft, light_samples, spp)
    if tracer is None:
        tracer = make_tracer(scene, method)
    else:
        tracer = dataclasses.replace(
            tracer, scene=scene,
            table=None if tracer.table is None else tri_table(scene.tris))
    rays = gen_primary_rays(cam)
    perm, inv = (torch.as_tensor(x, device=rays.o.device)
                 for x in pixel_morton_perm(cam.height, cam.width))
    color = render_rays(tracer, Rays(o=rays.o[perm], d=rays.d[perm]))
    return color[inv].reshape(cam.height, cam.width, 3)
