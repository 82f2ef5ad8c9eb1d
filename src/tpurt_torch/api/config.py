"""Render, fit and process-group settings (counterpart of
``tpurt/api/config.py``'s RenderConfig, FitConfig and DistConfig).  Only
the fields a ported path reads are here: FitConfig.seed has no reader in
tpurt either, and the Config container, file loading and flat overrides
wait for a path that calls them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class RenderConfig:
    """All render-path knobs."""

    # "brute" | "bvh" | "binary" | "wide8" | "packet" | "wave".  tpurt
    # defaults to "bvh", its per-ray walk; the port defaults to its BVH8
    # CUDA engine.
    method: str = "wide8"
    # treelet-cut leaf size of the binary engines' LBVH
    leaf_size: int = 8
    # jittered samples per pixel (Renderer.render)
    spp: int = 1
    # soft/differentiable path
    soft: bool = False
    k_layers: int = 4
    sharpness: float = 100.0
    band: float = 0.08
    # candidate occluders per (ray, light) in the soft shadow model
    k_occ: int = 8
    # area lights: Monte-Carlo samples per shading point on the scene's
    # emissive triangles (0: point lights only); light_seed seeds the
    # generator Renderer makes when none is passed
    light_samples: int = 0
    light_seed: int = 0

    def tracer_kwargs(self) -> dict[str, Any]:
        return dict(method=self.method, leaf_size=self.leaf_size,
                    band=self.band if self.soft else 0.0)

    def render_kwargs(self) -> dict[str, Any]:
        return dict(soft=self.soft, k_layers=self.k_layers,
                    sharpness=self.sharpness, band=self.band,
                    k_occ=self.k_occ, light_samples=self.light_samples)


@dataclass(frozen=True)
class FitConfig:
    """Inverse-rendering (fit) knobs."""

    steps: int = 200
    lr: float = 1e-2
    optimizer: str = "adam"  # "adam" | "sgd"
    fit_verts: bool = True
    fit_albedo: bool = True
    grad_chunks: int = 1  # ray chunks per step; bounds the backward's memory
    # checkpoints: every ckpt_every steps into ckpt_path (None: none); a fit
    # resumes from the latest one there
    ckpt_every: int = 50
    ckpt_path: str | None = None
    # rebuild-on-drift: every `rebuild_every` steps, rebuild the topology
    # when the refit tree's quality (InverseRenderer.tree_quality) has
    # degraded past rebuild_ratio x its at-build value; 0 disables it
    rebuild_every: int = 25
    rebuild_ratio: float = 2.0


@dataclass(frozen=True)
class DistConfig:
    """Process-group knobs: dist/runtime.init_distributed's arguments (None:
    torchrun's environment, or a world-1 group).  data_parallel is tpurt's
    field, which no path of either package reads."""

    data_parallel: bool = True
    coordinator: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
