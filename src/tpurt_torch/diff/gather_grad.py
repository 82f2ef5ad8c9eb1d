"""Row gathers whose backward accumulates into the gathered table
(counterpart of ``tpurt/diff/gather_grad.py``).

``gather_verts(verts, idx)`` is ``verts[idx]``; its backward sums the
cotangent rows into a (V, C) gradient by one of two backends, chosen
module-wide with ``set_grad_backend`` as in tpurt:

- ``'segsum'`` (tpurt's default): ``segment_accumulate``, a stable sort of
  the ids and a segmented scan (``kernels/segsum.py``, the CUDA kernels of
  ``csrc/segsum.cu`` on the card).  Its order of additions is fixed by the
  ids, so a backward, and so a fit, repeats bit for bit.
- ``'scatter'``: ``index_add_``, one atomic-add pass on the card, whose
  atomics sum in an order that may change from run to run.

``grad_cols`` restricts the backward to the first ``grad_cols`` columns; the
rest of the gradient is zero-filled without being summed.  Callers use it
only for columns whose gradient is never consumed (the soft path's emission
columns: emission is not a fit parameter).
"""

from __future__ import annotations

import torch

from tpurt_torch.kernels.segsum import segment_accumulate

_BACKEND = "segsum"  # 'segsum' | 'scatter'


def set_grad_backend(backend: str) -> None:
    """Select the gather backward ('segsum' | 'scatter') for every later
    backward in the process."""
    global _BACKEND
    if backend not in ("segsum", "scatter"):
        raise ValueError(backend)
    _BACKEND = backend


def get_grad_backend() -> str:
    return _BACKEND


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
        flat = cot.reshape(-1, cols)
        return accumulate_rows(idx.reshape(-1), flat[:, :use], ctx.rows, cols), None, None


def accumulate_rows(idx: torch.Tensor, cot: torch.Tensor, num_rows: int,
                    width: int) -> torch.Tensor:
    """The (num_rows, width) gradient of a row gather: the rows of cot (N,
    use) summed by idx (N,) int64 into its first use columns by the
    selected backend, the other width - use columns zero."""
    use = cot.shape[1]
    if _BACKEND == "scatter":
        grad = cot.new_zeros((num_rows, width))
        grad[:, :use].index_add_(0, idx, cot)
        return grad
    if cot.stride(-1) != 1:
        cot = cot.contiguous()
    grad = segment_accumulate(idx, cot, num_rows)
    if use < width:
        grad = torch.nn.functional.pad(grad, (0, width - use))
    return grad


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
