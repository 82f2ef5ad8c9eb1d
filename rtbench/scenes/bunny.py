"""The bunny-class object as numpy arrays, frozen: a bumpy torus-knot tube
over a ground plane, one point light.

A copy of the port's ``make_bunny_scene`` and ``_torus_knot_mesh``
(``core/scene.py``) as they stood when this file was written, so that a
later change to the port's generator cannot change what is measured: a
(2, 3) torus knot of n_u rings of n_v vertices, its tube's radius varied
ring by ring by a seeded normal draw, 2 n_u n_v triangles (69,938 for
70,000 asked), and a ground quad of 2 triangles at y = -1.6.  The port's
generator always draws with seed 0; ``rtbench/tests`` holds the arrays at
seed 0 bitwise equal to it.
"""

from __future__ import annotations

import numpy as np

from rtbench.frozen.scene import SceneArrays, _merge

LIGHT_POS = (3.0, 5.0, 4.0)
LIGHT_INTENSITY = (90.0, 90.0, 90.0)
BACKGROUND = (0.05, 0.07, 0.1)
AMBIENT = (0.02, 0.02, 0.02)       # the port's Scene.create default


def _torus_knot_mesh(n_u: int, n_v: int, seed: int, p: int = 2, q: int = 3):
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


def arrays(num_tris: int, seed: int) -> SceneArrays:
    """The knot of about num_tris triangles over the ground, its tube's
    bumps drawn from seed."""
    n_u = max(8, int(np.sqrt(num_tris / 2)))
    n_v = max(8, num_tris // (2 * n_u))
    v, f = _torus_knot_mesh(n_u, n_v, seed)
    ground_v = np.array(
        [[-8, -1.6, -8], [8, -1.6, -8], [8, -1.6, 8], [-8, -1.6, 8]], np.float32
    )
    ground_f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    verts, faces, albedo = _merge(
        [(v, f, (0.75, 0.55, 0.35)), (ground_v, ground_f, (0.5, 0.5, 0.55))]
    )
    albedo = np.ascontiguousarray(albedo, np.float32)
    return SceneArrays(
        verts=np.asarray(verts, np.float32), faces=np.asarray(faces, np.int32),
        albedo=albedo, emission=np.zeros_like(albedo),
        light_pos=np.asarray([LIGHT_POS], np.float32),
        light_intensity=np.asarray([LIGHT_INTENSITY], np.float32),
        background=np.asarray(BACKGROUND, np.float32),
        ambient=np.asarray(AMBIENT, np.float32))
