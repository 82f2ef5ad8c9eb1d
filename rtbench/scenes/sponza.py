"""The Sponza-class courtyard: ``frozen/scene.py``'s copy of the port's
``make_sponza_scene`` (a tessellated floor, a ring of 24 columns, seeded
clutter boxes), one point light at (6, 18, 4)."""

from rtbench.frozen import scene


def arrays(num_tris: int, seed: int) -> scene.SceneArrays:
    """The courtyard of about num_tris triangles, deterministic in seed."""
    return scene.sponza_arrays(num_tris, seed)
