"""Vector helpers and image output (counterpart of ``tpurt/core/math.py``)."""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def norm(a: torch.Tensor, keepdims: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(a, a, keepdims=keepdims), 1e-30))


def normalize(a: torch.Tensor) -> torch.Tensor:
    return a / norm(a, keepdims=True)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB, for image output."""
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * torch.pow(torch.clamp_min(linear, 1e-8), 1.0 / 2.4) - 0.055,
    )


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(srgb_encode(img) * 255.0 + 0.5, 0, 255).to(torch.uint8)


def sample_square(generator: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
    """Jittered offsets in [0, 1)^2 for AA: (*shape, 2) f32 on the
    generator's device.  tpurt draws them from a jax.random key; the two
    streams differ, so tests feed both packages the same numpy jitter."""
    return torch.rand((*shape, 2), generator=generator, device=generator.device,
                      dtype=torch.float32)
