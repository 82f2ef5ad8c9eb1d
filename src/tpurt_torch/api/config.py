"""Render, fit and process-group settings (counterpart of
``tpurt/api/config.py``): RenderConfig, FitConfig and DistConfig, the
Config that holds one of each, and load_config.

The field names, the JSON form (``Config.to_json``), the flat
``section.key`` overrides and their KeyError messages are tpurt's, so two
configs with equal fields have equal ``digest()`` in both packages and a
file written by either loads in the other.  One default differs:
RenderConfig.method is ``"wide8"`` here (the port's BVH8 CUDA engine)
and ``"bvh"`` in tpurt (its per-ray walk), so ``Config()`` digests differ
while ``Config.from_dict`` of the same dict does not.  A Config's sections
are what ``Renderer(scene, cfg.render)`` and ``InverseRenderer(scene, cam,
fit=cfg.fit, render=cfg.render)`` take."""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
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
    seed: int = 0  # tpurt's field; no path of either package reads it
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


@dataclass(frozen=True)
class Config:
    """One of each section; tpurt's serialisation and overrides."""

    render: RenderConfig = field(default_factory=RenderConfig)
    fit: FitConfig = field(default_factory=FitConfig)
    dist: DistConfig = field(default_factory=DistConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    def digest(self) -> str:
        """Stable short hash identifying this exact configuration."""
        return hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()).hexdigest()[:12]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        return cls(render=_apply(RenderConfig(), d.get("render", {})),
                   fit=_apply(FitConfig(), d.get("fit", {})),
                   dist=_apply(DistConfig(), d.get("dist", {})))

    def with_overrides(self, overrides: dict[str, Any]) -> "Config":
        """Apply flat 'section.key' -> value overrides (CLI --set form)."""
        d = self.to_dict()
        for key, val in overrides.items():
            section, _, name = key.partition(".")
            if not name:
                raise KeyError(f"override {key!r}: use section.key form")
            if section not in d or name not in d[section]:
                raise KeyError(f"unknown config key {key!r}")
            d[section][name] = val
        return Config.from_dict(d)


def _apply(base, updates: dict[str, Any]):
    """base with `updates` replaced; a value whose type differs from the
    field's current (non-None) value is converted to it, as tpurt does
    (so "0.5" becomes 0.5, and any non-empty string a True bool)."""
    names = {f.name for f in dataclasses.fields(base)}
    unknown = set(updates) - names
    if unknown:
        raise KeyError(f"unknown config keys {sorted(unknown)}")
    coerced = {}
    for k, v in updates.items():
        cur = getattr(base, k)
        if cur is not None and v is not None and not isinstance(v, type(cur)):
            v = type(cur)(v)
        coerced[k] = v
    return dataclasses.replace(base, **coerced)


def load_config(path: str | None = None, overrides: dict | None = None) -> Config:
    """Config() or the one in a JSON file (YAML where pyyaml imports),
    then the flat overrides."""
    cfg = Config()
    if path:
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml
            except ImportError as e:
                raise ValueError(f"{path}: not JSON and pyyaml unavailable") from e
            data = yaml.safe_load(text)
        cfg = Config.from_dict(data or {})
    if overrides:
        cfg = cfg.with_overrides(overrides)
    return cfg
