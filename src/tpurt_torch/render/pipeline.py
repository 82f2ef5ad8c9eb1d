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
- ``"bvh"``: tpurt's default engine, the per-ray plain-torch walks over the
  LBVH's threaded flat tree (accel/traverse_ref.py), on any device;
- ``"binary"``: the same tree packed (accel/packet.py) and walked by the
  binary kernels (kernels/traverse.py), the counterpart of tpurt's
  ``"pallas"``: CUDA kernels on the GPU, their plain-torch twins on the CPU;
- ``"wide8"``: the 8-wide BVH walks (kernels/traverse8.py), the counterpart
  of tpurt's ``"pallas8"``: CUDA kernels on the GPU, their plain-torch twins
  on the CPU;
- ``"packet"``: tpurt's packet engine over the packed tree
  (kernels/packet.py): 1,024 consecutive rays walk the union of their
  subtrees with one cursor and every ray of the packet is tested at each
  wanted leaf, so its hits are its own; CUDA kernels on the GPU, their
  plain-torch twins on the CPU.  Its primary rays are traced in row-major
  pixel order, as tpurt traces them, so each packet holds tpurt's rays;
- ``"wave"``: tpurt's wavefront engine (accel/wavefront.py), the
  lockstep escape walk of ``"bvh"`` over the same flat tree;
- ``"ring"``: the scene Morton-partitioned over a DeviceMesh, one chunk a
  rank, the rays rotated around the ranks (dist/ring.py), each chunk walked
  by ``ring_engine``: ``"wide8"`` (tpurt's ``"pallas8"`` ring, its
  WideBVH), ``"packet"`` (tpurt's ``"packet"`` ring: the packet kernels
  over its PackedBVH, each rank's resident block in 1,024-ray packets; its
  primary rays in row-major order, as for ``"packet"``) or ``"binary"``
  (the binary per-ray kernels over the same PackedBVH, which tpurt's ring
  does not offer).  Hard and soft; the hits come back to every rank, and
  the shading reads the replicated table.

Area lights: with light_samples > 0 and a torch.Generator, each render
draws light_samples points on the scene's emissive triangles
(render/shade.sample_emitters) and adds their Monte-Carlo direct light.
The hard render traces one shadow ray per (point, sample) through the
engine's any-hit walk (occluded8, occluded_bin on the card); the soft
render traces the candidate occluders toward the samples from layer 0
through its k-nearest walk (knear8, knear_bin) and evaluates the soft
transmittance of every layer, as for point lights.  Without a generator
nothing is sampled, as tpurt samples nothing without a key.

Spans (obs/trace.py; a profiler range each while a profiler runs):
``tpurt::render_rays`` holds a render; every engine's walks run in
``tpurt::walk.closest``, ``tpurt::walk.occluded`` and ``tpurt::walk.knear``
(the Tracer's methods), and the area lights in ``tpurt::area``, their
sampling in ``tpurt::area.sample``.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.accel.bvh8 import WideBVH, build_wide
from tpurt_torch.accel.intersect import (
    DEFAULT_T_MIN, DET_EPS, intersect_brute, occluded_brute)
from tpurt_torch.accel.lbvh import BVH, build_lbvh
from tpurt_torch.accel.packet import PackedBVH, max_cut_leaves, pack_bvh
from tpurt_torch.accel.traverse_ref import (
    k_nearest_ref, occluded_ref, occluder_ids_ref, traverse_ref)
from tpurt_torch.accel.wavefront import wave_closest, wave_k_ids, wave_occluded
from tpurt_torch.core.geometry import Camera, Hit, KHits, Rays, T_MAX
from tpurt_torch.core.math import cross, sample_square
from tpurt_torch.core.scene import Scene
from tpurt_torch.diff.gather_grad import gather_verts
from tpurt_torch.diff.intersect_vjp import intersect_tuv
from tpurt_torch.diff.softvis import (
    composite, coverage, cross3, det_gate, dot3, k_nearest_brute,
    soft_occlusion_layers_soa)
from tpurt_torch.dist.ring import ring_k_nearest, ring_occluded, ring_trace
from tpurt_torch.dist.scene_partition import (
    ScenePartition, build_partition_bvhs, build_partition_wides, partition_scene)
from tpurt_torch.kernels.packet import k_nearest_ids_packet, occluded_packet, traverse_packet
from tpurt_torch.kernels.traverse import (
    k_nearest_ids_packed, occluded_packed, traverse_packed)
from tpurt_torch.kernels.traverse8 import (
    k_nearest_wide8, occluded_wide8, traverse_wide8)
from tpurt_torch.obs.trace import spanned, trace_span
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm
from tpurt_torch.render.shade import (
    area_light_contrib, face_forward, light_dirs, sample_emitters, shade_lambert)

SHADOW_EPS = 1e-3  # offset shadow-ray origins off the surface
SHADOW_T_FRAC = 1.0 - 1e-3  # stop shadow rays just before the light
METHODS = ("brute", "bvh", "binary", "wide8", "packet", "wave", "ring")
RING_ENGINES = ("wide8", "binary", "packet")


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
    ``scene.tris`` and must track it.  The "ring" engine's state: the Morton
    partition ``part``, this rank's own chunk's tree ``pbvh`` (a WideBVH or
    a PackedBVH), the local engine ``ring_engine`` that walks it (one of
    RING_ENGINES: "binary" and "packet" both walk a PackedBVH) and the
    DeviceMesh ``mesh`` the rays rotate over."""

    scene: Scene
    bvh: BVH | None = None
    packed: PackedBVH | None = None
    wide: WideBVH | None = None
    table: torch.Tensor | None = None
    method: str = "brute"
    part: ScenePartition | None = None
    pbvh: WideBVH | PackedBVH | None = None
    mesh: DeviceMesh | None = None
    ring_engine: str | None = None

    @property
    def packets(self) -> bool:
        """Whether the closest-hit walk runs tpurt's packet engine, whose
        results depend on which rays share a 1,024-ray packet."""
        return self.method == "packet" or (self.method == "ring"
                                           and self.ring_engine == "packet")

    def _ring_pad(self, rays: Rays, *extra):
        """Flat rays (and per-ray tensors) padded to a multiple of the mesh
        with zero rays (and zeros) -> (Rays, n, extras)."""
        o, d = rays.o.reshape(-1, 3), rays.d.reshape(-1, 3)
        n = o.shape[0]
        pad = (-n) % self.mesh.size()
        extra = tuple(torch.as_tensor(e, dtype=torch.float32, device=o.device)
                      .expand(rays.shape).reshape(-1) for e in extra)
        if pad:
            o, d = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (o, d))
            extra = tuple(torch.nn.functional.pad(e, (0, pad)) for e in extra)
        return Rays(o=o, d=d), n, extra

    @spanned("tpurt::walk.closest")
    def closest_shaded(self, rays: Rays) -> tuple[Hit, tuple | None]:
        """(Hit, shade) where shade = (albedo, emission, raw normal) of the
        winning triangle straight from the wide8 walk, or None for the
        other engines (the hard render then reads the table)."""
        if self.method == "ring":
            flat, n, _ = self._ring_pad(rays)
            hit = ring_trace(self.mesh, flat, self.part, pbvh=self.pbvh,
                             engine=self.ring_engine)
            return Hit(**{f: getattr(hit, f)[:n].reshape(rays.shape)
                          for f in ("t", "u", "v", "tri")}), None
        if self.method == "wide8":
            return traverse_wide8(rays, self.wide, shade_out=True)
        if self.method == "binary":
            return traverse_packed(rays, self.packed), None
        if self.method == "packet":
            return traverse_packet(rays, self.packed), None
        if self.method == "wave":
            return wave_closest(rays, self.scene.tris, self.bvh), None
        if self.method == "bvh":
            return traverse_ref(rays, self.scene.tris, self.bvh), None
        return intersect_brute(rays, self.scene.tris), None

    @spanned("tpurt::walk.occluded")
    def visibility(self, rays: Rays, t_max: torch.Tensor) -> torch.Tensor:
        """Hard transmittance in (t_min, t_max): 1 visible, 0 occluded."""
        if self.method == "brute":
            occ = occluded_brute(rays, self.scene.tris, t_max=t_max)
        elif self.method == "bvh":
            occ = occluded_ref(rays, self.scene.tris, self.bvh, t_max)
        elif self.method == "binary":
            occ = occluded_packed(rays, self.packed, t_max)
        elif self.method == "packet":
            occ = occluded_packet(rays, self.packed, t_max)
        elif self.method == "wave":
            occ = wave_occluded(rays, self.scene.tris, self.bvh, t_max)
        elif self.method == "ring":
            flat, n, (tm,) = self._ring_pad(rays, t_max)
            occ = ring_occluded(self.mesh, flat, self.part, tm, pbvh=self.pbvh,
                                engine=self.ring_engine)[:n].reshape(rays.shape)
        else:
            occ = occluded_wide8(rays, self.wide, t_max)
        return 1.0 - occ.to(torch.float32)

    @torch.no_grad()
    @spanned("tpurt::walk.knear")
    def k_nearest(self, rays: Rays, k: int, band: float) -> KHits:
        """The k nearest band hits, front to back (ids only for the kernel
        engines: t, u, v are recomputed downstream and are zeros here).  No
        gradient."""
        if self.method == "brute":
            return k_nearest_brute(rays, self.scene.tris, k=k, band=band)
        if self.method == "bvh":
            return k_nearest_ref(rays, self.scene.tris, self.bvh, k=k, band=band)
        if self.method == "binary":
            ids = k_nearest_ids_packed(rays, self.packed, k, band, t_max=T_MAX)
        elif self.method == "packet":
            ids = k_nearest_ids_packet(rays, self.packed, k, band, t_max=T_MAX)
        elif self.method == "wave":
            ids = wave_k_ids(rays, self.scene.tris, self.bvh, k, band, t_max=T_MAX)
        elif self.method == "ring":
            flat, n, _ = self._ring_pad(rays)
            ids = ring_k_nearest(self.mesh, flat, self.part, self.table, k, band,
                                 pbvh=self.pbvh, engine=self.ring_engine)[:n]
        else:
            ids = k_nearest_wide8(rays, self.wide, k, band, t_max=T_MAX)
        z = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
        return KHits(t=z, u=z, v=z, tri=ids.reshape(*rays.shape, k))

    @torch.no_grad()
    @spanned("tpurt::walk.knear")
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
        if self.method == "bvh":
            return occluder_ids_ref(flat, self.scene.tris, self.bvh, k_occ, band,
                                    DEFAULT_T_MIN, 2.0 * tm)
        if self.method == "binary":
            return k_nearest_ids_packed(flat, self.packed, k_occ, band, t_max=2.0 * tm)
        if self.method == "packet":
            return k_nearest_ids_packet(flat, self.packed, k_occ, band, t_max=2.0 * tm)
        if self.method == "wave":
            return wave_k_ids(flat, self.scene.tris, self.bvh, k_occ, band, t_max=2.0 * tm)
        if self.method == "ring":
            flat, n, (tm,) = self._ring_pad(flat, tm)
            return ring_k_nearest(self.mesh, flat, self.part, self.table, k_occ, band,
                                  t_max=2.0 * tm, pbvh=self.pbvh,
                                  engine=self.ring_engine)[:n]
        return k_nearest_wide8(flat, self.wide, k_occ, band, t_max=2.0 * tm)


def make_tracer(scene: Scene, method: str = "brute", band: float = 0.0,
                leaf_size: int = 8, mesh=None, ring_engine: str = "wide8") -> Tracer:
    """Build a Tracer for `scene` on the scene's device: the table, and for
    the BVH engines the LBVH with its DFS thread at `leaf_size` (boxes
    inflated by `band`, which the soft path needs so near-miss band hits are
    not culled); for "binary" and "packet" its packed layout, with rows for
    the static bound max_cut_leaves as tpurt packs it; for "wide8" its
    8-wide collapse ("bvh" and "wave" walk the LBVH's flat tree).  "ring"
    (needs `mesh`, a DeviceMesh): the scene Morton-partitioned into one
    chunk a rank, and this rank's chunk's tree for `ring_engine` ("wide8":
    a WideBVH; "packet", tpurt's other ring engine, and "binary": a
    PackedBVH built as build_partition_bvhs builds it), which the Tracer
    records, so that every ring call walks the tree with that engine."""
    if method not in METHODS:
        raise ValueError(f"method {method!r} not in {METHODS}")
    table = tri_table(scene.tris)
    if method == "ring":
        if mesh is None:
            raise ValueError("method='ring' needs a DeviceMesh (mesh=, dist.shard.make_mesh)")
        if ring_engine not in RING_ENGINES:
            raise ValueError(f"ring_engine {ring_engine!r} not in {RING_ENGINES}")
        with torch.no_grad():
            part = partition_scene(scene.tris, mesh.size())
            rank = mesh.get_local_rank()
            pbvh = (build_partition_wides(part, scene.tris, band=band, index=rank)
                    if ring_engine == "wide8" else
                    build_partition_bvhs(part, leaf_size=leaf_size, band=band, index=rank))
        return Tracer(scene=scene, method=method, table=table, part=part, pbvh=pbvh,
                      mesh=mesh, ring_engine=ring_engine)
    if method == "brute":
        return Tracer(scene=scene, method=method, table=table)
    packed = wide = None
    with torch.no_grad():
        bvh = build_lbvh(scene.tris, leaf_size=leaf_size, band=band)
        if method in ("binary", "packet"):
            packed = pack_bvh(scene.tris, bvh, max_cut_leaves(scene.num_tris, leaf_size))
        elif method == "wide8":
            wide = build_wide(scene.tris, bvh)
    return Tracer(scene=scene, bvh=bvh, packed=packed, wide=wide, table=table,
                  method=method)


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


def area_shadow_rays(p: torch.Tensor, n: torch.Tensor, valid: torch.Tensor,
                     lp: torch.Tensor):
    """One shadow ray per (hit point, emitter sample lp (S, 3)), flattened
    sample-major (neighbouring rays toward one sample, as shadow_rays keeps
    neighbouring rays toward one light), with t_max just short of the
    sample; a missed primary ray gets t_max = 0.  Returns (Rays (S*R, 3),
    t_max (S*R,))."""
    o_surf = p + SHADOW_EPS * n
    delta = lp[None, :, :] - o_surf[:, None, :]                  # (R, S, 3)
    ldist = torch.sqrt(torch.clamp_min(torch.sum(delta * delta, dim=-1), 1e-12))
    lwi = delta / ldist[..., None]
    S, R = lp.shape[0], p.shape[0]
    o_al = o_surf[None].expand(S, R, 3).reshape(-1, 3)
    t_al = torch.where(valid[:, None], ldist * SHADOW_T_FRAC, 0.0).T.reshape(-1)
    return Rays(o=o_al, d=lwi.transpose(0, 1).reshape(-1, 3)), t_al


def _shade_layer(tracer: Tracer, rays: Rays, hit: Hit, shade=None,
                 light_samples: int = 0, generator: torch.Generator | None = None):
    """Shade the closest-hit layer with hard shadow rays -> color (R, 3);
    light_samples > 0 with a generator adds the area lights' Monte-Carlo
    direct light, one hard shadow ray per (point, sample)."""
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
    if light_samples > 0 and generator is not None:
        with trace_span("tpurt::area"):
            with trace_span("tpurt::area.sample"):
                lp, ln_, le, pdf, _ = sample_emitters(generator, scene.tris, light_samples)
            al_rays, t_al = area_shadow_rays(p, n, valid, lp)
            vis_al = tracer.visibility(al_rays, t_max=t_al).reshape(light_samples, R).T
            color = color + area_light_contrib(p, n, albedo, lp, ln_, le, pdf, vis_al)
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
                 band: float, k_occ: int, light_samples: int = 0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """K-layer soft render of flat rays (R, 3) -> (R, 3): one k-nearest walk
    for the layers, one for the shadow candidates of each (layer-0 point,
    light), shared by every layer; with light_samples > 0 and a generator
    the same toward each emitter sample (tpurt's shared_vis)."""
    scene = tracer.scene
    ids = tracer.k_nearest(rays, k=k_layers, band=band).tri     # (R, K)
    r, k = ids.shape
    surf = soft_surface(tracer.table, rays, ids)
    alphas = coverage(surf.u, surf.v, sharpness, surf.valid, band) * det_gate(surf.cos_dn)

    def shared_vis(light_pos: torch.Tensor) -> torch.Tensor:
        """Soft transmittance (R*K, n_l) toward n_l point positions from
        every layer, the candidates traced once from layer 0."""
        n_l = light_pos.shape[0]
        wi, dist, cand, t_seg = occluder_rays(surf, light_pos)
        occ = tracer.occluder_ids(cand, t_seg, k_occ, band)
        occ = occ.reshape(n_l, r, k_occ).permute(0, 2, 1)          # (L, C, R)
        vis = soft_occlusion_layers_soa(
            [surf.o_surf[i][:, None, None, :] for i in range(3)],
            [wi[i][:, :, None, :] for i in range(3)],
            (dist * SHADOW_T_FRAC)[:, :, None, :], occ, tracer.table,
            sharpness, band)                                        # (K, L, R)
        return vis.permute(2, 0, 1).reshape(r * k, -1)              # (R*K, L)

    if scene.lights.pos.shape[0] > 0:
        vis = shared_vis(scene.lights.pos)
    else:
        vis = torch.zeros((r * k, 0), dtype=torch.float32, device=ids.device)

    def aos3(comps):  # 3 x (K, R) -> (R*K, 3), ray-major layer order
        return torch.stack(comps, dim=-1).transpose(0, 1).reshape(-1, 3)

    pf, nf, alb = aos3(surf.p), aos3(surf.n), aos3(surf.albedo)
    color = shade_lambert(pf, nf, alb, aos3(surf.emission), scene.lights, vis,
                          scene.ambient)
    if light_samples > 0 and generator is not None:
        with trace_span("tpurt::area"):
            with trace_span("tpurt::area.sample"):
                lp, ln_, le, pdf, _ = sample_emitters(generator, scene.tris, light_samples)
            color = color + area_light_contrib(pf, nf, alb, lp, ln_, le, pdf, shared_vis(lp))
    colors = torch.where(surf.valid.T[..., None], color.reshape(r, k, 3), 0.0)
    return composite(alphas.T, colors, scene.background)


@spanned("tpurt::render_rays")
def render_rays(tracer: Tracer, rays: Rays, *, soft: bool = False,
                k_layers: int = 4, sharpness: float = 100.0, band: float = 0.08,
                k_occ: int = 8, light_samples: int = 0,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Radiance for a flat batch of rays -> (R, 3).

    soft=False: the hard closest-hit render.  soft=True: the differentiable
    K-layer render; k_occ candidate occluders per (ray, light), traced once
    from the nearest layer and shared by all layers.  light_samples > 0
    with a generator (on the scene's device): area light from that many
    points drawn on the emissive triangles, shared by the batch."""
    if soft:
        return _render_soft(tracer, rays, k_layers, sharpness, band, k_occ,
                            light_samples, generator)
    hit, shade = tracer.closest_shaded(rays)
    color = _shade_layer(tracer, rays, hit, shade, light_samples, generator)
    bg = tracer.scene.background.expand(color.shape)
    return torch.where(hit.valid[..., None], color, bg)


def render(scene: Scene, cam: Camera, *, method: str = "brute",
           tracer: Tracer | None = None, soft: bool = False, k_layers: int = 4,
           sharpness: float = 100.0, band: float = 0.08, k_occ: int = 8,
           spp: int = 1, generator: torch.Generator | None = None,
           light_samples: int = 0) -> torch.Tensor:
    """Render an (H, W, 3) linear-radiance image on the scene's device.

    A soft render builds its tracer with band-inflated boxes (band=band);
    a hard one with band 0.  spp > 1 with a generator averages spp
    jittered samples (render_image).  light_samples > 0 with a generator
    adds the emissive triangles' sampled area light (without one, nothing
    is sampled)."""
    if tracer is None:
        tracer = make_tracer(scene, method, band=band if soft else 0.0)
    else:
        tracer = dataclasses.replace(tracer, scene=scene, table=tri_table(scene.tris))
    return render_image(tracer, cam, spp=spp, generator=generator, soft=soft,
                        k_layers=k_layers, sharpness=sharpness, band=band, k_occ=k_occ,
                        light_samples=light_samples)


def render_image(tracer: Tracer, cam: Camera, spp: int = 1,
                 generator: torch.Generator | None = None, trace=None,
                 **kw) -> torch.Tensor:
    """The camera's (H, W, 3) image through render_rays(tracer, ..., **kw),
    or through trace(rays, generator=, **kw) when given (the Renderer's
    ray-sharded render).

    Primary rays are traced in Morton pixel order (neighbouring rays on
    neighbouring pixels) and the image is put back in row-major order; the
    per-ray engines give the same pixels in any order.  The packet
    engine's rays stay in row-major order, tpurt's (``"packet"``, and
    ``"ring"`` with ring_engine ``"packet"``; Tracer.packets): its packets
    are runs of 1,024 consecutive rays, and which rays share one is part of
    its result.  The shadow rays and the soft render's occluder queries
    follow from the primary rays' order, light-major, as tpurt's do.  With spp > 1 and a
    generator, the mean of spp samples, each with its own sub-pixel jitter
    from sample_square(generator); otherwise one sample at pixel centres,
    as tpurt's render does without a key.  The generator also draws each
    sample's emitter points when kw asks for light_samples."""
    run = trace or functools.partial(render_rays, tracer)
    if tracer.packets:
        perm = inv = slice(None)
    else:
        perm, inv = (torch.as_tensor(x, device=cam.eye.device)
                     for x in pixel_morton_perm(cam.height, cam.width))

    def one(jitter):
        rays = gen_primary_rays(cam, jitter)
        return run(Rays(o=rays.o[perm], d=rays.d[perm]), generator=generator, **kw)[inv]

    if spp <= 1 or generator is None:
        img = one(None)
    else:
        img = torch.zeros((cam.num_pixels, 3), dtype=torch.float32, device=cam.eye.device)
        for _ in range(spp):
            img = img + one(sample_square(generator, (cam.num_pixels,)))
        img = img / spp
    return img.reshape(cam.height, cam.width, 3)
