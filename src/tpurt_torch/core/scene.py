"""Scene container and the procedural scenes (counterpart of
``tpurt/core/scene.py``).

The generators are tpurt's numpy code, copied, so vertices, faces and albedo
are bitwise tpurt's for the same arguments; only the final conversion to
tensors on ``device`` differs.  The OBJ/PLY loaders are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpurt_torch.core.geometry import Camera, PointLight, Triangles


@dataclass
class Scene:
    tris: Triangles
    lights: PointLight
    background: torch.Tensor  # (3,) radiance for rays that miss
    ambient: torch.Tensor  # (3,) ambient irradiance term

    @classmethod
    def create(cls, tris, lights, background=(0.0, 0.0, 0.0),
               ambient=(0.02, 0.02, 0.02)) -> "Scene":
        dev = tris.device
        return cls(
            tris=tris, lights=lights,
            background=torch.tensor(np.asarray(background, np.float32), device=dev),
            ambient=torch.tensor(np.asarray(ambient, np.float32), device=dev),
        )

    @property
    def num_tris(self) -> int:
        return self.tris.num_tris


# ---------------------------------------------------------------------------
# Procedural scenes (numpy, host-side)
# ---------------------------------------------------------------------------
def _box_mesh(lo, hi, skip_bottom=False):
    """Axis-aligned box as 12 (or 10) triangles. Returns (verts, faces)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array(
        [
            [x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
            [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1],
        ],
        np.float32,
    )
    quads = [
        (0, 3, 2, 1),  # z0 (back)
        (4, 5, 6, 7),  # z1 (front)
        (0, 1, 5, 4),  # y0 (bottom)
        (3, 7, 6, 2),  # y1 (top)
        (0, 4, 7, 3),  # x0 (left)
        (1, 2, 6, 5),  # x1 (right)
    ]
    if skip_bottom:
        quads = [q for i, q in enumerate(quads) if i != 2]
    f = []
    for a, b, c, d in quads:
        f.append([a, b, c])
        f.append([a, c, d])
    return v, np.asarray(f, np.int32)


def _merge(parts):
    """Merge [(verts, faces, albedo)] into one indexed mesh."""
    vs, fs, als = [], [], []
    off = 0
    for v, f, al in parts:
        vs.append(v)
        fs.append(f + off)
        als.append(np.broadcast_to(np.asarray(al, np.float32), (len(f), 3)))
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs), np.concatenate(als)


def make_cornell_box(light_intensity: float = 2.8,
                     device="cuda") -> tuple[Scene, Camera]:
    """Cornell box, 30 triangles: 5 walls (10 tris) + two boxes without
    bottoms (2x10 tris). Camera on +z looking in."""
    white = (0.73, 0.73, 0.73)
    red = (0.65, 0.05, 0.05)
    green = (0.12, 0.45, 0.15)
    parts = []
    wall_quads = [
        ([[0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]], white),  # floor (y=0)
        ([[0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]], white),  # ceiling
        ([[0, 0, 0], [0, 1, 0], [1, 1, 0], [1, 0, 0]], white),  # back (z=0)
        ([[0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]], red),    # left (x=0)
        ([[1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]], green),  # right (x=1)
    ]
    for quad, col in wall_quads:
        v = np.asarray(quad, np.float32)
        f = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
        parts.append((v, f, col))
    v, f = _box_mesh([0.12, 0.0, 0.12], [0.42, 0.60, 0.42], skip_bottom=True)
    parts.append((v, f, white))
    v, f = _box_mesh([0.55, 0.0, 0.50], [0.83, 0.28, 0.78], skip_bottom=True)
    parts.append((v, f, white))
    verts, faces, albedo = _merge(parts)
    tris = Triangles.create(verts, faces, albedo=albedo, device=device)
    light = PointLight.create(pos=(0.5, 0.93, 0.62),
                              intensity=(light_intensity,) * 3, device=device)
    scene = Scene.create(tris, light, background=(0.0, 0.0, 0.0))
    cam = Camera.create(eye=(0.5, 0.5, 2.2), target=(0.5, 0.5, 0.0),
                        fov_y_deg=33.0, device=device)
    return scene, cam


def _torus_knot_mesh(n_u: int, n_v: int, p: int = 2, q: int = 3, seed: int = 0):
    """Smooth bumpy torus-knot tube of 2*n_u*n_v triangles with shared
    vertices."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    r = 0.5 * (2 + np.cos(q * u))
    cx = r * np.cos(p * u)
    cy = r * np.sin(p * u)
    cz = 0.5 * -np.sin(q * u)
    c = np.stack([cx, cy, cz], -1)
    t = np.roll(c, -1, 0) - np.roll(c, 1, 0)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    ref = np.array([0.0, 0.0, 1.0])
    b = np.cross(t, ref)
    b /= np.linalg.norm(b, axis=-1, keepdims=True) + 1e-9
    nrm = np.cross(b, t)
    v_ang = np.linspace(0, 2 * np.pi, n_v, endpoint=False)
    tube_r = 0.28 * (1.0 + 0.08 * rng.standard_normal(n_u)[:, None])
    ring = (
        c[:, None, :]
        + tube_r[..., None]
        * (
            np.cos(v_ang)[None, :, None] * nrm[:, None, :]
            + np.sin(v_ang)[None, :, None] * b[:, None, :]
        )
    )
    verts = ring.reshape(-1, 3).astype(np.float32)
    iu = np.arange(n_u)
    iv = np.arange(n_v)
    I, J = np.meshgrid(iu, iv, indexing="ij")
    a = I * n_v + J
    bq = ((I + 1) % n_u) * n_v + J
    cq = ((I + 1) % n_u) * n_v + (J + 1) % n_v
    dq = I * n_v + (J + 1) % n_v
    f1 = np.stack([a, bq, cq], -1).reshape(-1, 3)
    f2 = np.stack([a, cq, dq], -1).reshape(-1, 3)
    faces = np.concatenate([f1, f2]).astype(np.int32)
    return verts, faces


def make_bunny_scene(num_tris: int = 70_000,
                     device="cuda") -> tuple[Scene, Camera]:
    """'Bunny-class' scene: a bumpy torus knot above a ground plane, one
    point light."""
    n_u = max(8, int(np.sqrt(num_tris / 2)))
    n_v = max(8, num_tris // (2 * n_u))
    v, f = _torus_knot_mesh(n_u, n_v)
    ground_v = np.array(
        [[-8, -1.6, -8], [8, -1.6, -8], [8, -1.6, 8], [-8, -1.6, 8]], np.float32
    )
    ground_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    verts, faces, albedo = _merge(
        [(v, f, (0.75, 0.55, 0.35)), (ground_v, ground_f, (0.5, 0.5, 0.55))]
    )
    tris = Triangles.create(verts, faces, albedo=albedo, device=device)
    light = PointLight.create(pos=(3.0, 5.0, 4.0), intensity=(90.0,) * 3,
                              device=device)
    scene = Scene.create(tris, light, background=(0.05, 0.07, 0.1))
    cam = Camera.create(eye=(0.0, 1.8, 5.2), target=(0.0, 0.0, 0.0),
                        fov_y_deg=40.0, width=512, height=512, device=device)
    return scene, cam


def make_sponza_scene(num_tris: int = 1_000_000, seed: int = 7,
                      width: int = 1920, height: int = 1080,
                      device="cuda") -> tuple[Scene, Camera]:
    """'Sponza-class' architectural clutter: a courtyard of columns + floor +
    many random tessellated boxes, totalling ~num_tris.  Deterministic in
    `seed`."""
    rng = np.random.default_rng(seed)
    parts = []
    # Floor: large tessellated grid.
    gn = 32
    gx = np.linspace(-20, 20, gn + 1, dtype=np.float32)
    gz = np.linspace(-20, 20, gn + 1, dtype=np.float32)
    X, Z = np.meshgrid(gx, gz, indexing="ij")
    gv = np.stack([X, np.zeros_like(X), Z], -1).reshape(-1, 3)
    ii, jj = np.meshgrid(np.arange(gn), np.arange(gn), indexing="ij")
    a = ii * (gn + 1) + jj
    b = (ii + 1) * (gn + 1) + jj
    c = (ii + 1) * (gn + 1) + jj + 1
    d = ii * (gn + 1) + jj + 1
    gf = np.concatenate(
        [np.stack([a, b, c], -1).reshape(-1, 3),
         np.stack([a, c, d], -1).reshape(-1, 3)]
    ).astype(np.int32)
    parts.append((gv, gf, (0.45, 0.42, 0.38)))
    used = len(gf)

    # Columns: rings of cylinders (tessellated).
    n_cols = 24
    seg = 16
    for k in range(n_cols):
        ang = 2 * np.pi * k / n_cols
        cx, cz = 14 * np.cos(ang), 14 * np.sin(ang)
        th = np.linspace(0, 2 * np.pi, seg, endpoint=False)
        ring0 = np.stack(
            [cx + np.cos(th), np.zeros(seg), cz + np.sin(th)], -1
        ).astype(np.float32)
        ring1 = ring0 + np.array([0, 7.0, 0], np.float32)
        v = np.concatenate([ring0, ring1])
        idx = np.arange(seg)
        nxt = (idx + 1) % seg
        f = np.concatenate(
            [
                np.stack([idx, nxt, nxt + seg], -1),
                np.stack([idx, nxt + seg, idx + seg], -1),
            ]
        ).astype(np.int32)
        parts.append((v, f, (0.6, 0.58, 0.5)))
        used += len(f)

    # Clutter boxes, each subdivided so the triangle budget is met.
    remaining = max(0, num_tris - used)
    sub = 2
    tris_per_box = 12 * sub * sub
    n_boxes = max(1, remaining // tris_per_box)
    centers = rng.uniform(-18, 18, (n_boxes, 3)).astype(np.float32)
    centers[:, 1] = rng.uniform(0.2, 6.0, n_boxes)
    sizes = rng.uniform(0.15, 0.9, (n_boxes, 3)).astype(np.float32)
    colors = rng.uniform(0.2, 0.9, (n_boxes, 3)).astype(np.float32)

    tv, tf = _subdivided_box(sub)
    all_v = (
        centers[:, None, :] + sizes[:, None, :] * (tv[None, :, :] - 0.5)
    ).reshape(-1, 3)
    offs = (np.arange(n_boxes) * len(tv))[:, None, None]
    all_f = (tf[None, :, :] + offs).reshape(-1, 3).astype(np.int32)
    all_c = np.repeat(colors, len(tf), axis=0)
    parts.append((all_v, all_f, (1, 1, 1)))
    verts, faces, albedo = _merge(parts)
    albedo[used:] = all_c[: len(albedo) - used]

    tris = Triangles.create(verts, faces, albedo=albedo, device=device)
    light = PointLight.create(pos=(6.0, 18.0, 4.0), intensity=(2200.0,) * 3,
                              device=device)
    scene = Scene.create(tris, light, background=(0.35, 0.45, 0.65))
    cam = Camera.create(eye=(0.0, 4.5, 16.5), target=(0.0, 2.0, 0.0),
                        fov_y_deg=50.0, width=width, height=height,
                        device=device)
    return scene, cam


def _subdivided_box(sub: int):
    """Unit box [0,1]^3 with each face an (sub x sub) grid; 12*sub^2 tris."""
    vs, fs = [], []
    off = 0
    lin = np.linspace(0, 1, sub + 1, dtype=np.float32)
    U, V = np.meshgrid(lin, lin, indexing="ij")
    flat = np.zeros_like(U)
    one = np.ones_like(U)
    face_grids = [
        (U, V, flat), (V, U, one),     # z=0, z=1
        (U, flat, V), (V, one, U),     # y=0, y=1
        (flat, U, V), (one, V, U),     # x=0, x=1
    ]
    ii, jj = np.meshgrid(np.arange(sub), np.arange(sub), indexing="ij")
    a = ii * (sub + 1) + jj
    b = (ii + 1) * (sub + 1) + jj
    c = (ii + 1) * (sub + 1) + jj + 1
    d = ii * (sub + 1) + jj + 1
    quad_f = np.concatenate(
        [np.stack([a, b, c], -1).reshape(-1, 3),
         np.stack([a, c, d], -1).reshape(-1, 3)]
    )
    for gx, gy, gz in face_grids:
        v = np.stack([gx, gy, gz], -1).reshape(-1, 3)
        vs.append(v)
        fs.append(quad_f + off)
        off += len(v)
    return (np.concatenate(vs).astype(np.float32),
            np.concatenate(fs).astype(np.int32))


def get_scene(name: str, **kw) -> tuple[Scene, Camera]:
    """Scene registry: 'cornell', 'bunny', 'sponza', 'sponza5m'."""
    if name == "cornell":
        return make_cornell_box(**kw)
    if name == "bunny":
        return make_bunny_scene(**kw)
    if name == "sponza":
        return make_sponza_scene(**kw)
    if name == "sponza5m":
        kw.setdefault("num_tris", 5_000_000)
        kw.setdefault("width", 3840)
        kw.setdefault("height", 2160)
        return make_sponza_scene(**kw)
    raise ValueError(f"unknown scene {name!r}")
