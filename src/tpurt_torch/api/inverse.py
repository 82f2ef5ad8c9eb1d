"""Inverse renderer: fit vertices and albedo to a target image
(counterpart of ``tpurt/api/inverse.py``).

Each step: refit the tree to the current vertices (no rebuild: topology
frozen, no gradient; the WideBVH's boxes and rows for "wide8", the LBVH's
boxes and then the packed layout for "bvh" and "binary"), render the soft
image in
``grad_chunks`` ray chunks with loss = sum((color - target)^2), and update
the parameters with Adam or SGD at optax's defaults.  The gradient is
accumulated in table space: every dependence of the render on vertices and
albedo goes through the (T, 15) triangle table, so each chunk's backward
stops at a detached copy of the table, the chunks' table gradients add up
there, and one backward through the table brings them to the parameters.
That is tpurt's per-chunk gradient sum with the memory of one chunk
(dist/collectives.chunked_grad).

With a mesh (a DeviceMesh from ``dist.shard.make_mesh``; every rank runs
the same fit), the fit is data-parallel as tpurt's: the rays are padded to
``grad_chunks`` x the mesh size, rank r takes the r-th contiguous shard and
splits it into ``grad_chunks`` chunks, and each chunk's table gradient
(T x 15 f32) and loss are summed over the ranks by one asynchronous
all-reduce of 60 T + 4 bytes, issued as soon as the chunk's backward is
done, so it overlaps the next chunk's render.  The table gradient is what is
reduced, not the parameter gradients: the step's backward already stops at
the table, its size does not depend on which parameters are fit or on how
the triangles share vertices, and one backward through the table per step
follows the reduction on every rank, as without a mesh.  Every rank then
takes the same optimizer step, so the parameters stay equal; only the
mesh's first rank writes checkpoints.

The fit passes no generator, so it samples no emitters: a render config
with ``light_samples > 0`` fits the point-lit image, as tpurt's fit, which
passes no key, does.

With ``FitConfig.ckpt_path`` set, a fit resumes from the latest checkpoint
there (parameters and optimizer state) and saves one every ``ckpt_every``
steps, as tpurt's does (api/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.accel.bvh8 import refit_wide_direct
from tpurt_torch.accel.lbvh import range_minmax_sparse
from tpurt_torch.accel.packet import refit_packed
from tpurt_torch.accel.refit import refit_aabbs
from tpurt_torch.api.checkpoint import latest_step, restore_ckpt, save_ckpt
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.core.geometry import Camera, Rays
from tpurt_torch.core.scene import Scene
from tpurt_torch.dist.collectives import chunked_grad, rank_rows
from tpurt_torch.dist.shard import replicate
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import Tracer, make_tracer, render_rays, tri_table


def refit_tracer(tracer: Tracer, tris, table: torch.Tensor | None = None) -> Tracer:
    """The tracer with its tree refit to `tris` (topology frozen, no
    gradient): the WideBVH's boxes and rows for "wide8" (from `table`, the
    tri_table at the same vertices, when given), else the LBVH's boxes and
    flat tree and then the packed rows for "binary".  A tracer without a
    tree ("brute") is returned as it is."""
    if tracer.bvh is None:
        return tracer
    if tracer.wide is not None:
        return dataclasses.replace(tracer, wide=refit_wide_direct(tracer.wide, tris, table=table))
    bvh = refit_aabbs(tracer.bvh, tris, update_flat=True)
    packed = None if tracer.packed is None else refit_packed(tracer.packed, bvh, tris)
    return dataclasses.replace(tracer, bvh=bvh, packed=packed)


def make_optimizer(cfg: FitConfig, params: dict[str, torch.Tensor]):
    """optax.adam(lr) / optax.sgd(lr) at their defaults, in torch.optim."""
    leaves = list(params.values())
    if cfg.optimizer == "adam":
        return torch.optim.Adam(leaves, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(leaves, lr=cfg.lr)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")


@dataclass
class FitResult:
    """The fitted scene and parameters, the per-step loss (summed squared
    error over the pixel count) and, per step, the L2 norm of each
    parameter's gradient (a diagnostic: finite and non-zero when the render
    is differentiable where it matters)."""

    scene: Scene
    params: dict
    losses: list
    steps_run: int
    grad_norms: list


class InverseRenderer:
    """Fit scene parameters so the rendered image matches a target image.

    >>> inv = InverseRenderer(init_scene, cam, fit=FitConfig(steps=300))
    >>> result = inv.fit(target_image)
    >>> result.scene, result.losses
    """

    def __init__(self, scene: Scene, cam: Camera, fit: FitConfig | None = None,
                 render: RenderConfig | None = None, mesh: DeviceMesh | None = None):
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                            f"(dist.shard.make_mesh), not {type(mesh).__name__}")
        self.mesh = mesh
        if mesh is not None:
            scene = replicate(scene, mesh)
        self.fit_cfg = fit or FitConfig()
        self.render_cfg = render or RenderConfig(
            method="wide8", soft=True, k_layers=6, sharpness=40.0, band=0.15)
        if not self.render_cfg.soft:
            raise ValueError("inverse rendering requires RenderConfig(soft=True)")
        self.scene0 = scene
        self.cam = cam
        self.tracer0 = make_tracer(scene, **self.render_cfg.tracer_kwargs())
        self.rebuilds = 0
        self._quality0 = None  # at-build quality, computed lazily

    # -- parameters -------------------------------------------------------
    def init_params(self) -> dict[str, torch.Tensor]:
        p = {}
        if self.fit_cfg.fit_verts:
            p["verts"] = self.scene0.tris.verts.detach().clone().requires_grad_(True)
        if self.fit_cfg.fit_albedo:
            p["albedo"] = self.scene0.tris.albedo.detach().clone().requires_grad_(True)
        if not p:
            raise ValueError("nothing to fit: enable fit_verts or fit_albedo")
        return p

    def apply_params(self, params: dict[str, torch.Tensor]) -> Scene:
        tris = self.scene0.tris
        if "verts" in params:
            tris = dataclasses.replace(tris, verts=params["verts"])
        if "albedo" in params:
            tris = dataclasses.replace(tris, albedo=torch.clamp(params["albedo"], 0.0, 1.0))
        return dataclasses.replace(self.scene0, tris=tris)

    # -- one step ---------------------------------------------------------
    def _step(self, params: dict[str, torch.Tensor], opt, o: torch.Tensor,
             d: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """One fit step over the (padded) rays; returns the summed loss (a
        0-d tensor on the device) after updating params in place."""
        scene = self.apply_params(params)
        table = tri_table(scene.tris)
        leaf = table.detach().requires_grad_(True)
        frozen = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, verts=scene.tris.verts.detach(),
            albedo=scene.tris.albedo.detach()))
        tracer = self.tracer0
        if "verts" in params:
            with torch.profiler.record_function("tpurt::refit"):
                tracer = refit_tracer(tracer, frozen.tris, table=leaf.detach())
        tracer = dataclasses.replace(tracer, scene=frozen, table=leaf)
        rkw = self.render_cfg.render_kwargs()

        def chunk_loss(tab, oc, dc, tc):
            colors = render_rays(dataclasses.replace(tracer, table=tab), Rays(o=oc, d=dc),
                                 **rkw)
            return torch.sum((colors - tc) ** 2)

        loss, grad = chunked_grad(chunk_loss, leaf, (o, d, target),
                                  self.fit_cfg.grad_chunks, mesh=self.mesh)
        opt.zero_grad(set_to_none=True)
        table.backward(grad)
        opt.step()
        return loss

    # -- rebuild-on-drift -------------------------------------------------
    @torch.no_grad()
    def tree_quality(self, params: dict[str, torch.Tensor]) -> float:
        """Sum of node surface areas over the root's, of the LBVH's topology
        at these vertices: the expected node tests per random ray up to a
        constant.  Refit-only fits degrade it as vertices drift."""
        bvh = self.tracer0.bvh
        if bvh is None:
            return 1.0
        v0, v1, v2 = self.apply_params(params).tris.corners()
        tri_lo = torch.minimum(torch.minimum(v0, v1), v2)
        tri_hi = torch.maximum(torch.maximum(v0, v1), v2)
        order = bvh.tri_order.long()
        lo, hi = range_minmax_sparse(tri_lo[order], tri_hi[order], bvh.first, bvh.last)
        d = torch.clamp_min(hi - lo, 0.0)
        area = 2.0 * (d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0])
        return float(torch.sum(area) / torch.clamp_min(area[0], 1e-30))

    def _maybe_rebuild(self, params: dict[str, torch.Tensor]) -> bool:
        """Rebuild the tracer at the current vertices when the refit tree's
        quality passed rebuild_ratio x its at-build value."""
        if self._quality0 is None:
            self._quality0 = self.tree_quality(self.init_params())
        q = self.tree_quality(params)
        if q <= self.fit_cfg.rebuild_ratio * self._quality0:
            return False
        with torch.no_grad():
            scene = self.apply_params({k: v.detach() for k, v in params.items()})
            self.tracer0 = make_tracer(scene, **self.render_cfg.tracer_kwargs())
        self._quality0 = self.tree_quality(params)
        self.rebuilds += 1
        return True

    # -- driver loop ------------------------------------------------------
    def fit(self, target_image, steps: int | None = None,
            callback: Callable[[int, float], None] | None = None) -> FitResult:
        cfg = self.fit_cfg
        steps = cfg.steps if steps is None else steps
        rays = gen_primary_rays(self.cam)
        dev = rays.o.device
        target = torch.as_tensor(target_image, dtype=torch.float32,
                                 device=dev).reshape(-1, 3)
        # Pad so the chunks (of every rank) divide the batch: padded rays
        # have zero direction and never hit (a constant background term),
        # padded targets are 0.
        n = rays.shape[0]
        pad = (-n) % (cfg.grad_chunks * (1 if self.mesh is None else self.mesh.size()))
        o, d = rays.o, rays.d
        if pad:
            zeros = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
            o, d, target = (torch.cat([x, zeros]) for x in (o, d, target))
        if self.mesh is not None:
            rows = rank_rows(o.shape[0], self.mesh)
            o, d, target = o[rows], d[rows], target[rows]
        params = self.init_params()
        opt = make_optimizer(cfg, params)
        start = 0
        if cfg.ckpt_path and latest_step(cfg.ckpt_path) is not None:
            state, start = restore_ckpt(cfg.ckpt_path)
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(state["params"][k])
            opt.load_state_dict(state["opt"])
        losses, grad_norms = [], []
        for i in range(start, steps):
            loss = self._step(params, opt, o, d, target)
            grad_norms.append({k: float(torch.linalg.vector_norm(v.grad))
                               for k, v in params.items()})
            losses.append(float(loss) / n)
            if callback:
                callback(i, losses[-1])
            if (cfg.rebuild_every and "verts" in params
                    and (i + 1) % cfg.rebuild_every == 0):
                self._maybe_rebuild(params)
            if (cfg.ckpt_path and cfg.ckpt_every and (i + 1) % cfg.ckpt_every == 0
                    and (self.mesh is None or self.mesh.get_local_rank() == 0)):
                save_ckpt(cfg.ckpt_path, {"params": {k: v.detach() for k, v in params.items()},
                                          "opt": opt.state_dict()}, i + 1)
        final = {k: v.detach() for k, v in params.items()}
        return FitResult(scene=self.apply_params(final), params=final,
                         losses=losses, steps_run=steps - start, grad_norms=grad_norms)
