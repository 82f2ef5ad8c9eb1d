"""Renderer façade: scene in, image out (counterpart of
``tpurt/api/renderer.py``).

Holds the scene and its tracer (the acceleration structure built once, on
the scene's device) behind one object.  tpurt's jit cache has no
counterpart: PyTorch runs eagerly.  Sharding over a device mesh and the
partitioned ring are ``dist/``, not ported yet (ROADMAP.md queue 1, slice 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from tpurt_torch.api.config import RenderConfig
from tpurt_torch.core.geometry import Camera, Rays
from tpurt_torch.core.scene import Scene
from tpurt_torch.render.pipeline import (
    Tracer, make_tracer, render_image, render_rays, tri_table)


class Renderer:
    """Stateful façade: holds the scene and its tracer.

    >>> r = Renderer(scene, config=RenderConfig(method="wide8"))
    >>> img = r.render(cam)                               # (H, W, 3) radiance
    >>> img = r.render(cam, spp=16, generator=generator)  # jittered AA
    """

    def __init__(self, scene: Scene, config: RenderConfig | None = None,
                 mesh=None, partition: str = "auto"):
        """partition: tpurt's 'auto' | 'replicated' | 'ring'.  Without a
        mesh 'auto' and 'replicated' render on the scene's device; a mesh
        or 'ring' needs dist/ and raises."""
        if partition not in ("auto", "replicated", "ring"):
            raise ValueError(partition)
        if mesh is not None or partition == "ring":
            raise NotImplementedError(
                "a device mesh and the partitioned ring are not ported to "
                "tpurt_torch yet (ROADMAP.md queue 1, slice 5)")
        self.config = config or RenderConfig()
        self.scene = scene
        self._tracer = make_tracer(scene, **self.config.tracer_kwargs())

    @property
    def tracer(self) -> Tracer:
        return self._tracer

    def update_scene(self, scene: Scene, rebuild_bvh: bool = True) -> None:
        """Swap the scene; rebuild_bvh=False keeps the tree (vertex-only
        edits still need a refit: InverseRenderer does that)."""
        self.scene = scene
        if rebuild_bvh or self._tracer.bvh is None:
            self._tracer = make_tracer(scene, **self.config.tracer_kwargs())
        else:
            self._tracer = dataclasses.replace(self._tracer, scene=scene,
                                               table=tri_table(scene.tris))

    # -- rendering --------------------------------------------------------
    def _kwargs(self, overrides: dict[str, Any]) -> dict[str, Any]:
        return {**self.config.render_kwargs(), **overrides}

    def _generator(self, device, light_samples: int) -> torch.Generator:
        """The generator a render draws from when the caller passes none:
        seeded light_seed when it samples emitters (tpurt's light_seed key),
        else 0."""
        g = torch.Generator(device=device)
        g.manual_seed(self.config.light_seed if light_samples > 0 else 0)
        return g

    def render_rays(self, rays: Rays, generator: torch.Generator | None = None,
                    **overrides: Any) -> torch.Tensor:
        """Radiance (R, 3) of a flat batch of rays, with the config's render
        settings, any of them overridden by keyword.  light_samples > 0
        draws the emitter points from `generator`, one seeded light_seed
        when none is given."""
        kw = self._kwargs(overrides)
        if kw["light_samples"] > 0 and generator is None:
            generator = self._generator(rays.o.device, kw["light_samples"])
        return render_rays(self._tracer, rays, generator=generator, **kw)

    def render(self, cam: Camera, spp: int | None = None,
               generator: torch.Generator | None = None,
               **overrides: Any) -> torch.Tensor:
        """The (H, W, 3) linear-radiance image.  spp (default the config's)
        > 1 averages that many jittered samples and light_samples > 0 adds
        sampled area light, both drawn from `generator`; when none is
        given, from one on the camera's device seeded light_seed if the
        render samples emitters, else 0."""
        spp = self.config.spp if spp is None else spp
        kw = self._kwargs(overrides)
        if generator is None and (spp > 1 or kw["light_samples"] > 0):
            generator = self._generator(cam.eye.device, kw["light_samples"])
        return render_image(self._tracer, cam, spp=spp, generator=generator, **kw)
