"""The Sponza-class courtyard as numpy arrays, frozen.

A copy of the port's ``make_sponza_scene`` (``core/scene.py``) as it
stood when this benchmark was defined: a tessellated floor, a ring of 24
columns and seeded clutter boxes, each face of a box a 2 x 2 grid.  The
harness builds the port's Scene from these arrays and hands the same
arrays to the reference, so a later change to the port's generator cannot
change what is measured.  ``rtbench/tests`` holds the arrays bitwise equal
to the port's generator at small sizes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

LIGHT_POS = (6.0, 18.0, 4.0)
LIGHT_INTENSITY = (2200.0, 2200.0, 2200.0)
BACKGROUND = (0.35, 0.45, 0.65)
AMBIENT = (0.02, 0.02, 0.02)


@dataclass
class SceneArrays:
    """Indexed triangles (verts (V, 3) f32, faces (F, 3) i32), per-face
    albedo and emission (F, 3) f32, one point light, background and
    ambient radiance."""

    verts: np.ndarray
    faces: np.ndarray
    albedo: np.ndarray
    emission: np.ndarray
    light_pos: np.ndarray
    light_intensity: np.ndarray
    background: np.ndarray
    ambient: np.ndarray

    @property
    def num_tris(self) -> int:
        return int(self.faces.shape[0])


def _merge(parts):
    vs, fs, als = [], [], []
    off = 0
    for v, f, al in parts:
        vs.append(v)
        fs.append(f + off)
        als.append(np.broadcast_to(np.asarray(al, np.float32), (len(f), 3)))
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs), np.concatenate(als)


def _subdivided_box(sub: int):
    """Unit box [0,1]^3 with each face an (sub x sub) grid; 12*sub^2 tris."""
    vs, fs = [], []
    off = 0
    lin = np.linspace(0, 1, sub + 1, dtype=np.float32)
    U, V = np.meshgrid(lin, lin, indexing="ij")
    flat = np.zeros_like(U)
    one = np.ones_like(U)
    face_grids = [
        (U, V, flat), (V, U, one),
        (U, flat, V), (V, one, U),
        (flat, U, V), (one, V, U),
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


def sponza_arrays(num_tris: int = 1_000_000, seed: int = 7) -> SceneArrays:
    """The courtyard of about num_tris triangles, deterministic in seed."""
    rng = np.random.default_rng(seed)
    parts = []
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
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    albedo = np.ascontiguousarray(albedo, np.float32)
    return SceneArrays(
        verts=verts, faces=faces, albedo=albedo,
        emission=np.zeros_like(albedo),
        light_pos=np.asarray([LIGHT_POS], np.float32),
        light_intensity=np.asarray([LIGHT_INTENSITY], np.float32),
        background=np.asarray(BACKGROUND, np.float32),
        ambient=np.asarray(AMBIENT, np.float32))


def with_emitters(arrays: SceneArrays, count: int, radiance: float, seed: int) -> SceneArrays:
    """The arrays with `count` triangles, a seeded numpy choice without
    replacement, made emitters of radiance `radiance` (chip_smoke.py's
    ``with_emitters``: the generated courtyard carries none)."""
    ids = np.random.default_rng(seed).choice(arrays.num_tris, count, replace=False)
    emission = arrays.emission.copy()
    emission[ids] = radiance
    return SceneArrays(**{**arrays.__dict__, "emission": emission})
