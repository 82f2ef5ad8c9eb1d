"""Faults planted in the port's timed path, to see the check say not
correct: in the tests on the CPU, and on the card at a cell's own size
through ``control.py --fault``.  Each is planted for the length of a
``with planted(driver, name):`` block and taken out after it.

- frames: ``answer_altered`` (every radiance 1% high), ``half_the_batch``
  (the second half of a frame's rays left out, the mean of the first half
  in their place);
- fit: ``state_unchanged`` (Adam's step leaves the parameters as they
  were), ``half_the_batch`` (the step's gradient and loss from the first
  half of its rays, doubled), ``answer_altered`` (each step's loss 1%
  high).
"""

from __future__ import annotations

import contextlib

import torch


def _frames_altered(orig):
    def render_rays(self, rays, generator=None, **kw):
        return orig(self, rays, generator=generator, **kw) * 1.01 + 1e-3
    return render_rays


def _frames_half(orig):
    def render_rays(self, rays, generator=None, **kw):
        from tpurt_torch.core.geometry import Rays
        n = rays.o.shape[0] // 2
        out = orig(self, Rays(o=rays.o[:n], d=rays.d[:n]), generator=generator, **kw)
        return torch.cat([out, out.mean(0, keepdim=True).expand(rays.o.shape[0] - n, 3)])
    return render_rays


def _state_unchanged(orig):
    def make_optimizer(cfg, params):
        opt = orig(cfg, params)
        step = opt.step

        def kept(*a, **kw):
            before = [p.detach().clone() for p in params.values()]
            out = step(*a, **kw)
            with torch.no_grad():
                for p, b in zip(params.values(), before):
                    p.copy_(b)
            return out
        opt.step = kept
        return opt
    return make_optimizer


def _fit_half(orig):
    def chunked_grad(loss_fn, params, chunk_args, n_chunks, mesh=None):
        rows = chunk_args[0].shape[0] // 2
        loss, grads = orig(loss_fn, params, tuple(x[:rows] for x in chunk_args),
                           max(1, n_chunks // 2), mesh=mesh)
        if isinstance(grads, dict):
            return 2.0 * loss, {k: 2.0 * g for k, g in grads.items()}
        return 2.0 * loss, 2.0 * grads
    return chunked_grad


def _fit_altered(orig):
    def chunked_grad(*a, **kw):
        loss, grads = orig(*a, **kw)
        return loss * 1.01, grads
    return chunked_grad


def _targets():
    from tpurt_torch.api import inverse
    from tpurt_torch.api.renderer import Renderer
    return {
        ("frames", "answer_altered"): (Renderer, "render_rays", _frames_altered),
        ("frames", "half_the_batch"): (Renderer, "render_rays", _frames_half),
        ("fit", "state_unchanged"): (inverse, "make_optimizer", _state_unchanged),
        ("fit", "half_the_batch"): (inverse, "chunked_grad", _fit_half),
        ("fit", "answer_altered"): (inverse, "chunked_grad", _fit_altered),
    }


NAMES = {"frames": ("answer_altered", "half_the_batch"),
         "fit": ("state_unchanged", "half_the_batch", "answer_altered")}


@contextlib.contextmanager
def planted(driver: str, name: str):
    owner, attr, make = _targets()[(driver, name)]
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)
