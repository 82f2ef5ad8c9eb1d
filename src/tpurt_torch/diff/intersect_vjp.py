"""Analytic backward for Möller–Trumbore (counterpart of
``tpurt/diff/intersect_vjp.py``).

``intersect_tuv`` returns the smooth (t, u, v) of ``accel/intersect.py``'s
forward (one definition, the same op order) and differentiates them by the
closed form instead of autograd's recorded graph: the backward recomputes the
few forward intermediates from the five saved inputs.

    e1 = v1 - v0, e2 = v2 - v0, p = d x e2, det = e1.p,
    inv = det / (det^2 + eps), tv = o - v0, q = tv x e1,
    u = (tv.p) inv, v = (d.q) inv, t = (e2.q) inv.

Adjoints: for c = a x b, a_bar += b x c_bar and b_bar += c_bar x a; for
s = a.b, a_bar += s_bar b; d(inv)/d(det) = (eps - det^2) / (det^2 + eps)^2.
"""

from __future__ import annotations

import torch

from tpurt_torch.accel import intersect as _mt
from tpurt_torch.core.math import cross, dot


class _IntersectTUV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, d, v0, v1, v2):
        ctx.save_for_backward(o, d, v0, v1, v2)
        t, u, v, _ = _mt.intersect_tuv(o, d, v0, v1, v2)
        return t, u, v

    @staticmethod
    def backward(ctx, t_bar, u_bar, v_bar):
        o, d, v0, v1, v2 = ctx.saved_tensors
        e1 = v1 - v0
        e2 = v2 - v0
        p = cross(d, e2)
        det = dot(e1, p)
        denom = det * det + _mt.DET_EPS
        inv = det / denom
        tv = o - v0
        q = cross(tv, e1)
        a, b, c = dot(tv, p), dot(d, q), dot(e2, q)  # u = a inv, v = b inv, t = c inv

        inv_bar = a * u_bar + b * v_bar + c * t_bar
        det_bar = inv_bar * (_mt.DET_EPS - det * det) / (denom * denom)
        a_bar, b_bar, c_bar = u_bar * inv, v_bar * inv, t_bar * inv

        def bc(s, vec):
            return s[..., None] * vec

        p_bar = bc(a_bar, tv) + bc(det_bar, e1)
        q_bar = bc(b_bar, d) + bc(c_bar, e2)
        tv_bar = bc(a_bar, p) + cross(e1, q_bar)   # q = tv x e1
        e1_bar = bc(det_bar, p) + cross(q_bar, tv)
        d_bar = bc(b_bar, q) + cross(e2, p_bar)    # p = d x e2
        e2_bar = bc(c_bar, q) + cross(p_bar, d)

        grads = (tv_bar, d_bar, -tv_bar - e1_bar - e2_bar, e1_bar, e2_bar)
        return tuple(g.sum_to_size(x.shape) if need else None
                     for g, x, need in zip(grads, (o, d, v0, v1, v2),
                                           ctx.needs_input_grad))


def intersect_tuv(o, d, v0, v1, v2):
    """Smooth (t, u, v) for broadcast-compatible (..., 3) inputs with the
    analytic backward; hit masking is the caller's."""
    return _IntersectTUV.apply(o, d, v0, v1, v2)
