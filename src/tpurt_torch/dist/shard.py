"""Ray sharding, the renderer's data-parallel axis (counterpart of
``tpurt/dist/shard.py``).

Rays are the batch dimension of a ray tracer: every pixel is independent.
The mesh is 1-D, its one dimension named "rays": rank r renders the r-th of
W equal contiguous slices of the (padded) flat ray batch, as tpurt's
``P('rays')`` lays it out, against a replicated scene and tree, and the
film comes back to every rank through one all-gather.  A sharded render
equals the single-process render bitwise per pixel: sharding only re-tiles
the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tpurt_torch.core.geometry import Rays
from tpurt_torch.dist.collectives import all_gather_tree, rank_rows
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import Tracer, render_rays

RAY_AXIS = "rays"


def make_mesh(device_type: str = "cuda", axis_name: str = RAY_AXIS) -> DeviceMesh:
    """The 1-D mesh over every rank of the default group (made first by
    dist/runtime.init_distributed): NCCL on "cuda", gloo on "cpu"."""
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def pad_rays(rays: Rays, multiple: int) -> tuple[Rays, int]:
    """Pad a flat ray batch to a multiple of `multiple` with zero-direction
    rays, which never hit.  Returns (padded, original n)."""
    n = rays.o.shape[0]
    m = (-n) % multiple
    if m == 0:
        return rays, n
    z = rays.o.new_zeros((m, 3))
    return Rays(o=torch.cat([rays.o, z]), d=torch.cat([rays.d, z])), n


def device_put_sharded_rays(rays: Rays, mesh: DeviceMesh) -> Rays:
    """This rank's slice of a flat ray batch padded to a mesh multiple."""
    rows = rank_rows(rays.o.shape[0], mesh)
    return Rays(o=rays.o[rows], d=rays.d[rows])


def shard_render_rays(tracer: Tracer, rays: Rays, mesh: DeviceMesh,
                      **render_kw: Any) -> torch.Tensor:
    """Render a flat ray batch (R, 3) with the rays sharded over the mesh
    and the tracer replicated: no collective until the film's all-gather,
    after which every rank holds all R colors."""
    padded, n = pad_rays(rays, mesh.size())
    colors = render_rays(tracer, device_put_sharded_rays(padded, mesh), **render_kw)
    return all_gather_tree({"film": colors}, mesh)["film"][:n]


def shard_render(tracer: Tracer, cam, mesh: DeviceMesh, **render_kw: Any) -> torch.Tensor:
    """The camera's (H, W, 3) image, its rays sharded over the mesh."""
    colors = shard_render_rays(tracer, gen_primary_rays(cam), mesh, **render_kw)
    return colors.reshape(cam.height, cam.width, 3)


def _map_tensors(tree, fn):
    """fn applied to every tensor of a tensor, dict, list, tuple or
    dataclass of them (a Scene, a Tracer), the containers rebuilt."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tensors(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree) if f.init})
    return tree


@torch.no_grad()
def replicate(tree, mesh: DeviceMesh):
    """A copy of a tree (tensor, dict, list, tuple or dataclass of them,
    such as a Scene) whose every tensor holds the mesh's first rank's bytes,
    broadcast to every rank; the caller's tensors are left as they are."""
    src = mesh.mesh.flatten().tolist()[0]

    def put(t: torch.Tensor) -> torch.Tensor:
        x = t.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(x, src=src, group=mesh.get_group())
        return x

    return _map_tensors(tree, put)
