"""Render pipeline: primary rays -> hits -> shadow rays -> Lambert shading
(counterpart of ``tpurt/render/pipeline.py``).

Two renders:
- hard (``soft=False``): the closest hit, one shadow ray per light;
- soft (``soft=True``): the differentiable K-layer render.  The K nearest
  band hits of each ray and the k_occ nearest candidate occluders of each
  (layer-0 point, light) segment are discrete ids from the engine, without
  gradient; every attribute (t, u, v, normals, coverage, transmittance) is
  recomputed from the differentiable triangle table, so the gradient is the
  same whichever engine found the ids.

Engines (``Tracer.method``):
- ``"brute"``: the O(rays x triangles) oracle (accel/intersect.py,
  diff/softvis.k_nearest_brute);
- ``"wide8"``: the 8-wide BVH walks (kernels/traverse8.py), the counterpart
  of tpurt's ``"pallas8"``: CUDA kernels on the GPU, their plain-torch twins
  on the CPU.

Area-light sampling and multi-sample rendering are not ported yet; asking
for them raises.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpurt_torch.accel.bvh8 import WideBVH, build_wide
from tpurt_torch.accel.intersect import DET_EPS, intersect_brute, occluded_brute
from tpurt_torch.accel.lbvh import BVH, build_lbvh
from tpurt_torch.core.geometry import Camera, Hit, KHits, Rays, T_MAX
from tpurt_torch.core.math import cross
from tpurt_torch.core.scene import Scene
from tpurt_torch.diff.gather_grad import gather_verts
from tpurt_torch.diff.intersect_vjp import intersect_tuv
from tpurt_torch.diff.softvis import (
    composite, coverage, cross3, det_gate, dot3, k_nearest_brute,
    soft_occlusion_layers_soa)
from tpurt_torch.kernels.traverse8 import (
    k_nearest_wide8, occluded_wide8, traverse_wide8)
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm
from tpurt_torch.render.shade import face_forward, light_dirs, shade_lambert

SHADOW_EPS = 1e-3  # offset shadow-ray origins off the surface
SHADOW_T_FRAC = 1.0 - 1e-3  # stop shadow rays just before the light
METHODS = ("brute", "wide8")


def _require_ported(light_samples: int, spp: int = 1) -> None:
    for asked, what in ((light_samples > 0, "area-light sampling (light_samples > 0)"),
                        (spp > 1, "multi-sample rendering (spp > 1)")):
        if asked:
            raise NotImplementedError(
                f"{what} is not ported to tpurt_torch yet (ROADMAP.md queue 1, "
                f"item 17)")


def tri_table(tris) -> torch.Tensor:
    """Per-triangle (T, 15) f32 table [v0, e1, e2, albedo, emission],
    differentiable in verts (through gather_verts) and albedo.  Rebuild it
    whenever the triangles change."""
    v = gather_verts(tris.verts, tris.faces)  # (T, 3 corners, 3)
    v0 = v[:, 0]
    return torch.cat([v0, v[:, 1] - v0, v[:, 2] - v0, tris.albedo,
                      tris.emission], dim=-1)


@dataclass
class Tracer:
    """Traversal engine bound to a scene.  ``table`` is tri_table of
    ``scene.tris`` and must track it."""

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

    @torch.no_grad()
    def k_nearest(self, rays: Rays, k: int, band: float) -> KHits:
        """The k nearest band hits, front to back (ids only for wide8: t, u,
        v are recomputed downstream and are zeros here).  No gradient."""
        if self.method == "brute":
            return k_nearest_brute(rays, self.scene.tris, k=k, band=band)
        ids = k_nearest_wide8(rays, self.wide, k, band, t_max=T_MAX)
        z = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        return KHits(t=z, u=z, v=z, tri=ids.reshape(*rays.shape, k))

    @torch.no_grad()
    def occluder_ids(self, rays: Rays, t_max, k_occ: int, band: float) -> torch.Tensor:
        """The k_occ nearest candidate occluders per flat ray in
        (t_min, 2 t_max) -> (N, k_occ) int32, -1 padded.  No gradient."""
        flat = Rays(o=rays.o.reshape(-1, 3), d=rays.d.reshape(-1, 3))
        tm = torch.as_tensor(t_max, dtype=torch.float32, device=flat.o.device)
        tm = tm.expand(rays.shape).reshape(-1)
        if self.method == "brute":
            ids = k_nearest_brute(flat, self.scene.tris, k=k_occ, band=band,
                                  t_max=2.0 * tm.reshape(-1, 1)).tri
            if ids.shape[1] < k_occ:  # k_nearest_brute clamps k to T
                ids = torch.nn.functional.pad(ids, (0, k_occ - ids.shape[1]), value=-1)
            return ids
        return k_nearest_wide8(flat, self.wide, k_occ, band, t_max=2.0 * tm)


def make_tracer(scene: Scene, method: str = "brute", band: float = 0.0) -> Tracer:
    """Build a Tracer for `scene` on the scene's device: the table, and for
    "wide8" the LBVH (boxes inflated by `band`, which the soft path needs
    so near-miss band hits are not culled) and its 8-wide collapse."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    table = tri_table(scene.tris)
    if method == "brute":
        return Tracer(scene=scene, method=method, table=table)
    with torch.no_grad():
        bvh = build_lbvh(scene.tris, band=band)
        wide = build_wide(scene.tris, bvh)
    return Tracer(scene=scene, bvh=bvh, wide=wide, table=table, method=method)


def _surface_attrs(rays: Rays, table: torch.Tensor, tri_id: torch.Tensor):
    """Hit point, face-forward unit normal, albedo and emission of the given
    triangles (one table row per ray; t recomputed by Möller–Trumbore),
    differentiable in the table.  Callers mask invalid ids."""
    row = gather_verts(table, tri_id.clamp_min(0))
    v0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    t, _, _ = intersect_tuv(rays.o, rays.d, v0, v0 + e1, v0 + e2)
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


@dataclass
class SoftSurface:
    """The soft render's per-(layer, ray) surface, ray index last: each
    vector a list of 3 (K, R) tensors."""

    valid: torch.Tensor   # (K, R) bool
    u: torch.Tensor
    v: torch.Tensor
    cos_dn: torch.Tensor
    p: list
    n: list               # unit, facing the ray
    albedo: list
    emission: list
    o_surf: list          # p offset by SHADOW_EPS along n


def soft_surface(table: torch.Tensor, rays: Rays, ids: torch.Tensor) -> SoftSurface:
    """Attributes of the (R, K) layer ids: one (K, R) table-row gather
    (grad_cols=12: the emission columns are gradient-dead, as emission is
    never a fit parameter) and Möller–Trumbore in component form."""
    ids_t = ids.T
    valid = ids_t >= 0
    row = gather_verts(table, ids_t.clamp_min(0), 12)      # (K, R, 15)
    c = row.unbind(-1)
    v0, e1, e2, alb, emi = c[0:3], c[3:6], c[6:9], c[9:12], c[12:15]
    oc = [rays.o[:, i][None] for i in range(3)]             # (1, R)
    dc = [rays.d[:, i][None] for i in range(3)]
    pv = cross3(dc, e2)
    det = dot3(e1, pv)
    inv = det / (det * det + DET_EPS)
    tv = [oc[i] - v0[i] for i in range(3)]
    u = dot3(tv, pv) * inv
    qv = cross3(tv, e1)
    v = dot3(dc, qv) * inv
    t = dot3(e2, qv) * inv
    nr = cross3(e1, e2)
    inv_nlen = torch.rsqrt(torch.clamp_min(dot3(nr, nr), 1e-40))
    inv_dlen = torch.rsqrt(torch.clamp_min(dot3(dc, dc), 1e-40))
    flip = torch.where(dot3(nr, dc) > 0.0, -inv_nlen, inv_nlen)
    n = [nr[i] * flip for i in range(3)]
    p = [oc[i] + t * dc[i] for i in range(3)]
    return SoftSurface(valid=valid, u=u, v=v, cos_dn=det * inv_nlen * inv_dlen,
                       p=p, n=n, albedo=list(alb), emission=list(emi),
                       o_surf=[p[i] + SHADOW_EPS * n[i] for i in range(3)])


def occluder_rays(surf: SoftSurface, light_pos: torch.Tensor):
    """Directions and lengths from every layer's point to each light, and
    the candidate rays traced once from layer 0, light-major.  Returns
    (wi: 3 x (K, L, R), dist (K, L, R), Rays (L*R, 3), segment t_max (L*R,));
    a missed layer-0 ray gets t_max = 0 and starts dead."""
    n_l, r = light_pos.shape[0], surf.valid.shape[1]
    lp = [light_pos[:, i][None, :, None] for i in range(3)]      # (1, L, 1)
    delta = [lp[i] - surf.p[i][:, None, :] for i in range(3)]    # (K, L, R)
    dist = torch.sqrt(torch.clamp_min(dot3(delta, delta), 1e-12))
    wi = [delta[i] / dist for i in range(3)]
    o_sh = torch.stack([surf.o_surf[i][0][None].expand(n_l, r) for i in range(3)],
                       dim=-1).reshape(-1, 3)
    d_sh = torch.stack([wi[i][0] for i in range(3)], dim=-1).reshape(-1, 3)
    t_cand = torch.where(surf.valid[0][None], dist[0], 0.0).reshape(-1)
    return wi, dist, Rays(o=o_sh, d=d_sh), t_cand * SHADOW_T_FRAC


def _render_soft(tracer: Tracer, rays: Rays, k_layers: int, sharpness: float,
                 band: float, k_occ: int) -> torch.Tensor:
    """K-layer soft render of flat rays (R, 3) -> (R, 3), point lights only:
    one k-nearest walk for the layers, one for the shadow candidates of
    each (layer-0 point, light), shared by every layer."""
    scene = tracer.scene
    ids = tracer.k_nearest(rays, k=k_layers, band=band).tri     # (R, K)
    r, k = ids.shape
    surf = soft_surface(tracer.table, rays, ids)
    alphas = coverage(surf.u, surf.v, sharpness, surf.valid, band) * det_gate(surf.cos_dn)
    n_l = scene.lights.pos.shape[0]
    if n_l > 0:
        wi, dist, cand, t_seg = occluder_rays(surf, scene.lights.pos)
        occ = tracer.occluder_ids(cand, t_seg, k_occ, band)
        occ = occ.reshape(n_l, r, k_occ).permute(0, 2, 1)          # (L, C, R)
        vis = soft_occlusion_layers_soa(
            [surf.o_surf[i][:, None, None, :] for i in range(3)],
            [wi[i][:, :, None, :] for i in range(3)],
            (dist * SHADOW_T_FRAC)[:, :, None, :], occ, tracer.table,
            sharpness, band)                                        # (K, L, R)
        vis = vis.permute(2, 0, 1).reshape(r * k, -1)               # (R*K, L)
    else:
        vis = torch.zeros((r * k, 0), dtype=torch.float32, device=ids.device)

    def aos3(comps):  # 3 x (K, R) -> (R*K, 3), ray-major layer order
        return torch.stack(comps, dim=-1).transpose(0, 1).reshape(-1, 3)

    color = shade_lambert(aos3(surf.p), aos3(surf.n), aos3(surf.albedo),
                          aos3(surf.emission), scene.lights, vis, scene.ambient)
    colors = torch.where(surf.valid.T[..., None], color.reshape(r, k, 3), 0.0)
    return composite(alphas.T, colors, scene.background)


def render_rays(tracer: Tracer, rays: Rays, *, soft: bool = False,
                k_layers: int = 4, sharpness: float = 100.0, band: float = 0.08,
                k_occ: int = 8, light_samples: int = 0) -> torch.Tensor:
    """Radiance for a flat batch of rays -> (R, 3).

    soft=False: the hard closest-hit render.  soft=True: the differentiable
    K-layer render; k_occ candidate occluders per (ray, light), traced once
    from the nearest layer and shared by all layers."""
    _require_ported(light_samples)
    if soft:
        return _render_soft(tracer, rays, k_layers, sharpness, band, k_occ)
    hit, shade = tracer.closest_shaded(rays)
    color = _shade_layer(tracer, rays, hit, shade)
    bg = tracer.scene.background.expand(color.shape)
    return torch.where(hit.valid[..., None], color, bg)


def render(scene: Scene, cam: Camera, *, method: str = "brute",
           tracer: Tracer | None = None, soft: bool = False, k_layers: int = 4,
           sharpness: float = 100.0, band: float = 0.08, k_occ: int = 8,
           spp: int = 1, light_samples: int = 0) -> torch.Tensor:
    """Render an (H, W, 3) linear-radiance image on the scene's device.

    A soft render builds its tracer with band-inflated boxes (band=band);
    a hard one with band 0.  Primary rays are traced in Morton pixel order
    (neighbouring rays on neighbouring pixels) and the image is put back in
    row-major order; the per-ray engines give the same pixels in any
    order."""
    _require_ported(light_samples, spp)
    if tracer is None:
        tracer = make_tracer(scene, method, band=band if soft else 0.0)
    else:
        tracer = dataclasses.replace(tracer, scene=scene, table=tri_table(scene.tris))
    rays = gen_primary_rays(cam)
    perm, inv = (torch.as_tensor(x, device=rays.o.device)
                 for x in pixel_morton_perm(cam.height, cam.width))
    color = render_rays(tracer, Rays(o=rays.o[perm], d=rays.d[perm]), soft=soft,
                        k_layers=k_layers, sharpness=sharpness, band=band,
                        k_occ=k_occ)
    return color[inv].reshape(cam.height, cam.width, 3)
