"""Render and fit settings (counterpart of ``tpurt/api/config.py``'s
RenderConfig and FitConfig).  Fields that no ported path reads are left out
(tpurt's spp, light_seed, ckpt_every and seed come with the sampling and
checkpoints that read them); the Config container, YAML loading and
overrides are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass(frozen=True)
class RenderConfig:
    """All render-path knobs."""

    # "brute" | "bvh" | "binary" | "wide8".  tpurt defaults to "bvh", its
    # per-ray walk; the port defaults to its BVH8 CUDA engine.
    method: str = "wide8"
    # treelet-cut leaf size of the binary engines' LBVH
    leaf_size: int = 8
    # soft/differentiable path
    soft: bool = False
    k_layers: int = 4
    sharpness: float = 100.0
    band: float = 0.08
    # candidate occluders per (ray, light) in the soft shadow model
    k_occ: int = 8
    # area lights (not ported; > 0 raises): samples per shading point
    light_samples: int = 0

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
    ckpt_path: str | None = None  # checkpoints are not ported yet: set raises
    # rebuild-on-drift: every `rebuild_every` steps, rebuild the topology
    # when the refit tree's quality (InverseRenderer.tree_quality) has
    # degraded past rebuild_ratio x its at-build value; 0 disables it
    rebuild_every: int = 25
    rebuild_ratio: float = 2.0
