"""Row gathers whose backward accumulates into the gathered table
(counterpart of ``tpurt/diff/gather_grad.py``).

``gather_verts(verts, idx)`` is ``verts[idx]``; its backward sums the
cotangent rows into a zero (V, C) tensor with ``index_add_``.  tpurt sorts
and segment-sums instead, because a scatter-add was slow on its TPU; on a
GPU ``index_add_`` is one atomic-add pass, so only the semantics are ported.
The atomics sum in an order that may change from run to run.

``grad_cols`` restricts the backward to the first ``grad_cols`` columns; the
rest of the gradient is zero-filled without being summed.  Callers use it
only for columns whose gradient is never consumed (the soft path's emission
columns: emission is not a fit parameter).
"""

from __future__ import annotations

import torch


class _GatherVerts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, verts, idx, grad_cols):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.grad_cols = verts.shape[0], grad_cols
        return verts[idx]

    @staticmethod
    def backward(ctx, cot):
        (idx,) = ctx.saved_tensors
        cols = cot.shape[-1]
        use = cols if ctx.grad_cols is None else min(ctx.grad_cols, cols)
        grad = cot.new_zeros((ctx.rows, cols))
        grad[:, :use].index_add_(0, idx.reshape(-1),
                                 cot.reshape(-1, cols)[:, :use])
        return grad, None, None


def gather_verts(verts: torch.Tensor, idx: torch.Tensor,
                 grad_cols: int | None = None) -> torch.Tensor:
    """``verts[idx]`` (shape idx.shape + (C,)) with an accumulating backward.
    idx: any integer shape, invalid ids clamped to a valid row by the caller
    (their cotangents are zero by masking downstream)."""
    return _GatherVerts.apply(verts, idx.long(), grad_cols)


def gather_corners(verts: torch.Tensor, faces: torch.Tensor, tid: torch.Tensor):
    """Corners (v0, v1, v2) of the triangles `tid` through one gather, so one
    accumulation on the way back.  Callers clamp invalid ids and mask."""
    v = gather_verts(verts, faces[tid.long()])  # (..., 3 corners, 3)
    return v[..., 0, :], v[..., 1, :], v[..., 2, :]
