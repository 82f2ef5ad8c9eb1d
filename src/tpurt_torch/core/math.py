"""Vector helpers, random streams and image output (counterpart of
``tpurt/core/math.py``).

Random numbers are torch's: sample_square draws from a torch.Generator and
pixel_rng hashes a seed and a pixel index.  tpurt draws from jax.random
(threefry) keys; its bits are not part of its contract, and the two
packages' streams differ, so tests feed both the same numpy samples.
"""

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


def make_onb(n: torch.Tensor):
    """Orthonormal basis from a unit normal, branchless (Duff et al.):
    (tangent, bitangent, n), each (..., 3)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    bt = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt, n


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return d - 2.0 * dot(d, n, keepdims=True) * n


def smoothstep(e0, e1, x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for x in [0, 2^32) held in int64, in two 16-bit halves
    of c so that no product leaves int64."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _U32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def pixel_rng(seed: int, pixel_index: torch.Tensor) -> torch.Tensor:
    """A per-pixel seed in [0, 2^32) (int64, pixel_index's shape) from a
    base seed and each pixel's index, by a counter-based hash: it depends on
    the pair alone (deterministic, independent of the order or batch the
    pixels come in), and distinct indices below 2^32 give distinct seeds.
    Seed a torch.Generator with one to give a pixel its own stream.  tpurt
    folds the index into a jax.random key instead."""
    base = _fmix32(torch.tensor((seed ^ (seed >> 32)) & _U32, dtype=torch.int64))
    idx = pixel_index.to(torch.int64) & _U32
    return _fmix32((_mul32(idx, 0x9E3779B9) + base.to(idx.device)) & _U32)


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
