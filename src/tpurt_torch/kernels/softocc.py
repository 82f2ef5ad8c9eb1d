"""Soft shadow transmittance on the card: the forward and the backward of
``diff/softvis.py`` ``soft_occlusion_layers_soa``, one hand-written CUDA
launch each (``csrc/softocc.cu``).

tpurt has no Pallas kernel for it (XLA computes ``soft_occlusion_layers_soa``
there).  ``forward`` gives the (K, L, R) transmittance of every layer's
shadow segment toward every light from the shared (L, C, R) candidate ids;
``backward`` gives, for a cotangent of it, the gradients of the origins,
directions and segment lengths and each candidate's (L, C, R, 9) table
cotangent row, recomputed from the inputs.  ``diff/softvis.py``'s
autograd Function calls both and sums the rows into the table through the
gather backward (segsum by default, a fixed order).  The plain versions
are softvis.py's composition (``soft_occlusion_layers_plain``) and its
rendering of the backward's maths (``soft_occlusion_layers_vjp``); CPU
tensors go there, never here.  A CUDA tensor reaches the kernels or the
call raises.
"""

from __future__ import annotations

import torch

from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream

# The most candidates a ray the kernels take (csrc/softocc.cu kMaxC): the
# count is rounded up to 4, 8 or 16.
KMAX = 16

# Kernel launches since the last reset_launches(): one a forward or a
# backward call that launches its kernel; only a real CUDA launch counts.
LAUNCHES = {"softocc_fwd": 0, "softocc_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _raise_on(err: int, stage: str) -> None:
    if err:
        raise RuntimeError(f"softocc {stage} kernel launch failed: {_build.error_string(err)}")


def _inputs(o, d, t_max, ids, table):
    """Checked kernel inputs: o 3 x (K, R), d 3 x (K, L, R), t_max (K, L,
    R) f32 CUDA tensors (made contiguous), ids (L, C, R) int32 at any
    strides, table (T, >= 9) f32 with unit column stride."""
    tm = t_max
    if tm.dim() != 3:
        raise ValueError(f"t_max must be (K, L, R), got {tuple(tm.shape)}")
    k, n_l, r = tm.shape
    vecs = list(o) + list(d) + [tm, table]
    dev = tm.device
    if dev.type != "cuda":
        raise ValueError(f"the softocc kernels take CUDA tensors, got one on {dev}")
    if any(x.device != dev for x in vecs) or ids.device != dev:
        raise ValueError("the softocc inputs lie on more than one device")
    if any(x.dtype != torch.float32 for x in vecs):
        raise TypeError("the softocc kernels take float32 origins, directions, lengths "
                        "and table")
    if len(o) != 3 or len(d) != 3 or any(x.shape != (k, r) for x in o) \
            or any(x.shape != (k, n_l, r) for x in d):
        raise ValueError(f"o must be 3 x (K, R) and d 3 x (K, L, R) for t_max "
                         f"{tuple(tm.shape)}")
    if ids.dim() != 3 or ids.shape[0] != n_l or ids.shape[2] != r:
        raise ValueError(f"ids must be (L, C, R) = ({n_l}, C, {r}), got {tuple(ids.shape)}")
    if ids.shape[1] > KMAX:
        raise ValueError(f"the softocc kernels take at most {KMAX} candidates a ray, "
                         f"got {ids.shape[1]}")
    if table.dim() != 2 or table.shape[1] < 9 or table.stride(1) != 1:
        raise ValueError(f"table must be (T, >= 9) with unit column stride, got "
                         f"{tuple(table.shape)}")
    if max(r, k * n_l * r, ids.numel()) >= 1 << 31:
        raise ValueError("the softocc kernels index rays and ids in 32 bits")
    ids = ids if ids.dtype == torch.int32 else ids.to(torch.int32)
    return ([x.contiguous() for x in o], [x.contiguous() for x in d], tm.contiguous(), ids,
            table)


def _args(o, d, tm, ids, table, sharpness, band, t_min):
    """The entry points' common leading arguments."""
    k, n_l, r = tm.shape
    return (*(_ptr(x) for x in (*o, *d, tm, ids)), *ids.stride(), ids.shape[1], _ptr(table),
            table.stride(0), k, n_l, r, sharpness, band, 1.0 + band, 0.5 * band, t_min)


def forward(o, d, t_max, ids, table, sharpness: float, band: float,
            t_min: float) -> torch.Tensor:
    """prod over the C candidates of (1 - alpha): the (K, L, R) f32
    transmittance (softvis.py soft_occlusion_layers_plain's value)."""
    o, d, tm, ids, table = _inputs(o, d, t_max, ids, table)
    vis = torch.empty(tm.shape, dtype=torch.float32, device=tm.device)
    if vis.numel() == 0:
        return vis
    with _build.on_device(tm):
        _raise_on(_build.load().tpurt_softocc_fwd(
            *_args(o, d, tm, ids, table, sharpness, band, t_min), _ptr(vis),
            _stream(tm.device)), "forward")
    LAUNCHES["softocc_fwd"] += 1
    return vis


def backward(o, d, t_max, ids, table, sharpness: float, band: float, t_min: float,
             g: torch.Tensor):
    """The vector-Jacobian product of forward for the cotangent g (K, L, R):
    (go 3 x (K, R), gd 3 x (K, L, R), gt_max (K, L, R), rows (L, C, R, 9)),
    rows[l, c, r] candidate ids[l, c, r]'s table cotangent (v0, e1, e2),
    summed over the layers; 0 for a -1 id."""
    o, d, tm, ids, table = _inputs(o, d, t_max, ids, table)
    if g.shape != tm.shape or g.dtype != torch.float32 or g.device != tm.device:
        raise ValueError(f"g must be a float32 {tuple(tm.shape)} tensor on {tm.device}")
    g = g.contiguous()
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=tm.device)  # noqa: E731
    k, n_l, r = tm.shape
    go, gd, gtm = [new(k, r) for _ in range(3)], [new(k, n_l, r) for _ in range(3)], new(k, n_l, r)
    rows = new(n_l, ids.shape[1], r, 9)
    if gtm.numel() == 0:
        return [x.zero_() for x in go], gd, gtm, rows.zero_()
    with _build.on_device(tm):
        _raise_on(_build.load().tpurt_softocc_bwd(
            *_args(o, d, tm, ids, table, sharpness, band, t_min), _ptr(g),
            *(_ptr(x) for x in (*go, *gd, gtm, rows)), _stream(tm.device)), "backward")
    LAUNCHES["softocc_bwd"] += 1
    return go, gd, gtm, rows
