"""Inverse renderer: fit vertices and albedo to a target image
(counterpart of ``tpurt/api/inverse.py``, one device).

Each step: refit the WideBVH's boxes and rows to the current vertices (no
rebuild: topology frozen, no gradient), render the soft image in
``grad_chunks`` ray chunks with loss = sum((color - target)^2), and update
the parameters with Adam or SGD at optax's defaults.  The gradient is
accumulated in table space: every dependence of the render on vertices and
albedo goes through the (T, 15) triangle table, so each chunk's backward
stops at a detached copy of the table, the chunks' table gradients add up
there, and one backward through the table brings them to the parameters.
That is tpurt's per-chunk gradient sum with the memory of one chunk.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import torch

from tpurt_torch.accel.bvh8 import refit_wide_direct
from tpurt_torch.accel.lbvh import range_minmax_sparse
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.core.geometry import Camera, Rays
from tpurt_torch.core.scene import Scene
from tpurt_torch.render.camera import gen_primary_rays
from tpurt_torch.render.pipeline import make_tracer, render_rays, tri_table


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
                 render: RenderConfig | None = None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh (data-parallel fit) is not ported to tpurt_torch "
                "yet (ROADMAP.md queue 1, slice 5)")
        self.fit_cfg = fit or FitConfig()
        if self.fit_cfg.ckpt_path:
            raise NotImplementedError(
                "fit checkpoints (ckpt_path) are not ported to tpurt_torch yet "
                "(ROADMAP.md queue 1, item 17)")
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
        wide = self.tracer0.wide
        if wide is not None and "verts" in params:
            with torch.profiler.record_function("tpurt::refit"):
                wide = refit_wide_direct(wide, frozen.tris, table=leaf.detach())
        tracer = dataclasses.replace(self.tracer0, scene=frozen, wide=wide, table=leaf)
        rkw = self.render_cfg.render_kwargs()
        n = self.fit_cfg.grad_chunks
        loss = torch.zeros((), dtype=torch.float32, device=o.device)
        for oc, dc, tc in zip(o.reshape(n, -1, 3), d.reshape(n, -1, 3),
                              target.reshape(n, -1, 3)):
            colors = render_rays(tracer, Rays(o=oc, d=dc), **rkw)
            chunk_loss = torch.sum((colors - tc) ** 2)
            chunk_loss.backward()
            loss = loss + chunk_loss.detach()
        opt.zero_grad(set_to_none=True)
        table.backward(torch.zeros_like(table) if leaf.grad is None else leaf.grad)
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
        # Pad so the chunks divide the batch: padded rays have zero direction
        # and never hit (a constant background term), padded targets are 0.
        n = rays.shape[0]
        pad = (-n) % cfg.grad_chunks
        o, d = rays.o, rays.d
        if pad:
            zeros = torch.zeros((pad, 3), dtype=torch.float32, device=dev)
            o, d, target = (torch.cat([x, zeros]) for x in (o, d, target))
        params = self.init_params()
        opt = make_optimizer(cfg, params)
        losses, grad_norms = [], []
        for i in range(steps):
            loss = self._step(params, opt, o, d, target)
            grad_norms.append({k: float(torch.linalg.vector_norm(v.grad))
                               for k, v in params.items()})
            losses.append(float(loss) / n)
            if callback:
                callback(i, losses[-1])
            if (cfg.rebuild_every and "verts" in params
                    and (i + 1) % cfg.rebuild_every == 0):
                self._maybe_rebuild(params)
        final = {k: v.detach() for k, v in params.items()}
        return FitResult(scene=self.apply_params(final), params=final,
                         losses=losses, steps_run=steps, grad_norms=grad_norms)
