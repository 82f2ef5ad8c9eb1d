"""Renderer façade: scene in, image out (counterpart of
``tpurt/api/renderer.py``).

Holds the scene and its tracer (the acceleration structure built once, on
the scene's device) behind one object.  tpurt's jit cache has no
counterpart: PyTorch runs eagerly.

With a mesh (a 1-D ``torch.distributed`` DeviceMesh from
``dist.shard.make_mesh``; every rank constructs the Renderer and calls it
alike), the scene is broadcast from the mesh's first rank and the render
is either "replicated" (the rays sharded over the ranks, dist/shard.py) or
"ring" (the scene Morton-partitioned over the ranks, dist/ring.py).  Either
way every rank gets the whole image.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.api.config import RenderConfig
from tpurt_torch.core.geometry import Camera, Rays
from tpurt_torch.core.scene import Scene
from tpurt_torch.dist.shard import replicate, shard_render_rays
from tpurt_torch.render.pipeline import (
    Tracer, make_tracer, render_image, render_rays, tri_table)


class Renderer:
    """Stateful façade: holds the scene and its tracer.

    >>> r = Renderer(scene, config=RenderConfig(method="wide8"))
    >>> img = r.render(cam)                               # (H, W, 3) radiance
    >>> img = r.render(cam, spp=16, generator=generator)  # jittered AA
    """

    # scenes at or above this size default to the partitioned ring on a mesh
    AUTO_PARTITION_TRIS = 2_000_000

    def __init__(self, scene: Scene, config: RenderConfig | None = None,
                 mesh: DeviceMesh | None = None, partition: str = "auto"):
        """partition (with a mesh): 'replicated' shards the rays over the
        mesh against a replicated scene and tree; 'ring' partitions the
        scene over the mesh, each chunk walked by the wide8 kernels (the
        binary ones for method "binary"); 'auto' picks 'ring' for scenes
        of AUTO_PARTITION_TRIS or more, else 'replicated'.  Without a mesh
        the render runs on the scene's device."""
        if partition not in ("auto", "replicated", "ring"):
            raise ValueError(partition)
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(dist.shard.make_mesh), not {type(mesh).__name__}")
        if partition == "auto":
            partition = ("ring" if mesh is not None
                         and scene.num_tris >= self.AUTO_PARTITION_TRIS else "replicated")
        if partition == "ring" and mesh is None:
            raise ValueError("partition='ring' requires a mesh (a DeviceMesh from "
                             "dist.shard.make_mesh)")
        self.config = config or RenderConfig()
        self.mesh = mesh
        self.partition = partition
        self.scene = scene if mesh is None else replicate(scene, mesh)
        self._tracer = make_tracer(self.scene, **self._tracer_kwargs())

    def _tracer_kwargs(self) -> dict[str, Any]:
        kw = self.config.tracer_kwargs()
        if self.partition == "ring":
            kw.update(method="ring", mesh=self.mesh,
                      ring_engine="binary" if self.config.method == "binary" else "wide8")
        return kw

    @property
    def tracer(self) -> Tracer:
        return self._tracer

    def update_scene(self, scene: Scene, rebuild_bvh: bool = True) -> None:
        """Swap the scene; rebuild_bvh=False keeps the tree (vertex-only
        edits still need a refit: InverseRenderer does that).  A ring
        partition is always rebuilt: its chunks' trees hold the geometry and
        have no refit, so keeping them would render stale triangles."""
        self.scene = scene if self.mesh is None else replicate(scene, self.mesh)
        scene = self.scene
        if rebuild_bvh or self.partition == "ring" or self._tracer.bvh is None:
            self._tracer = make_tracer(scene, **self._tracer_kwargs())
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
        return self._render_rays(rays, generator=generator, **kw)

    def _render_rays(self, rays: Rays, **kw: Any) -> torch.Tensor:
        """render_rays through this Renderer's tracer, the rays sharded
        over the mesh when the scene is replicated on one."""
        if self.mesh is not None and self.partition == "replicated":
            return shard_render_rays(self._tracer, rays, self.mesh, **kw)
        return render_rays(self._tracer, rays, **kw)

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
        return render_image(self._tracer, cam, spp=spp, generator=generator,
                            trace=self._render_rays, **kw)
