"""Sorted segment-sum: the deterministic backward of a row gather
(counterpart of tpurt's ``diff/gather_grad.py`` ``segment_accumulate``).

``segment_accumulate(idx, cot, num_rows)`` sums the rows of ``cot`` by id
into a (num_rows, C) tensor.  tpurt computes it in XLA, with no Pallas
kernel: a stable sort of the ids, a two-level segmented scan (a log-shift
scan inside blocks of 256 sorted rows, then a log-shift composition of the
blocks' carries), and a read of each segment's last row.  It uses no
scatter, so the order of every addition is fixed by the ids alone and the
sum repeats bit for bit, which ``index_add_``'s atomics do not.

For CUDA tensors the sort is ``torch.sort(stable=True)`` on int32 keys (a
library sort, as tpurt's ``lax.sort`` is) and the rest runs in the
hand-written kernels of ``csrc/segsum.cu``: (a) the in-block scan, (b) the
carry, one launch per log-shift pass, and (c) the end rows.  For CPU
tensors ``segment_accumulate_ref`` runs: tpurt's algorithm in tpurt's order
of additions, written in whole-tensor torch ops, so that the kernels and it
agree bit for bit (+0 and -0 aside), and it agrees with tpurt as floats.
There is no other route: a CUDA tensor either reaches the kernels or the
call raises.
"""

from __future__ import annotations

import dataclasses

import torch

from tpurt_torch.kernels import _build
from tpurt_torch.kernels._build import ptr as _ptr, stream as _stream

# Rows of a scan block (tpurt's B): 8 log-shift passes inside a block.
BLOCK = 256
# The kernels index rows and ids in 32 bits.
MAX_ROWS = (1 << 31) - 1

# Kernel launches since the last reset_launches(): one a segment_accumulate
# call that launches the three kernels; only a real CUDA launch counts.
LAUNCHES = {"segsum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def carry_passes(nb: int) -> int:
    """Log-shift passes of the carry over nb blocks (shifts 1, 2, 4, ... < nb)."""
    return max(nb - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# Plain-torch twin
# ---------------------------------------------------------------------------
def _shift(x: torch.Tensor, sh: int, dim: int, fill) -> torch.Tensor:
    """x moved sh places up `dim`, the first sh filled with `fill`
    (jnp.pad(x, (sh, 0)) cut to x's length)."""
    pad = [0, 0] * (x.dim() - 1 - dim) + [sh, 0]
    return torch.nn.functional.pad(x, pad, value=fill).narrow(dim, 0, x.shape[dim])


def segment_accumulate_ref(idx: torch.Tensor, cot: torch.Tensor,
                           num_rows: int) -> torch.Tensor:
    """Plain-torch twin: out[v] = sum of the rows cot[i] with idx[i] == v,
    (num_rows, C), summed in tpurt's order.  idx (N,) integer in [0,
    num_rows); cot (N, C) float."""
    n, c = cot.shape
    if n == 0:
        return cot.new_zeros((num_rows, c))
    sidx, perm = torch.sort(idx.to(torch.int32), stable=True)
    pad = (-n) % BLOCK
    sid2 = torch.cat([sidx, sidx.new_full((pad,), num_rows)]).reshape(-1, BLOCK)
    y = torch.cat([cot[perm], cot.new_zeros((pad, c))]).reshape(-1, BLOCK, c)
    nb = sid2.shape[0]
    # in-block segmented scan: 8 log-shift passes, segments start where the
    # id changes (row 0 of a block always starts one)
    blk = sid2 != _shift(sid2, 1, 1, -1)
    sh = 1
    while sh < BLOCK:
        bpad = _shift(blk, sh, 1, True)
        y = torch.where(blk[..., None], y, y + _shift(y, sh, 1, 0.0))
        blk = blk | bpad
        sh *= 2
    # block carries: carry[b] = g[b] + a[b] * carry[b - 1], by a log-shift
    # composition over the nb blocks
    head, tail = sid2[:, 0], sid2[:, -1]
    full = head == tail
    cont = _shift(tail, 1, 0, -2) == head
    a = (cont & _shift(full, 1, 0, False)).to(cot.dtype)
    gs = torch.where(cont[:, None], _shift(y[:, -1], 1, 0, 0.0), 0.0)
    aa = a
    sh = 1
    while sh < nb:
        as_ = _shift(aa, sh, 0, 0.0)
        gs = gs + aa[:, None] * _shift(gs, sh, 0, 0.0)
        aa = aa * as_
        sh *= 2
    # only a block's first piece (the rows with its head id) takes the carry
    first = sid2 == head[:, None]
    y = y + gs[:, None, :] * first[..., None]
    # each id's total is its segment's last row, at cumsum(counts) - 1
    counts = torch.bincount(idx.long(), minlength=num_rows)
    g = torch.clamp_min(torch.cumsum(counts, 0) - 1, 0)
    ends = y.reshape(-1, c)[g]
    return torch.where((counts > 0)[:, None], ends, 0.0)


# ---------------------------------------------------------------------------
# CUDA wrapper
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Work:
    """One segment_accumulate on the card: the sorted ids and their
    permutation, the input, and the kernels' outputs and scratch."""

    sid: torch.Tensor    # (N,) int32, sorted
    perm: torch.Tensor   # (N,) int64, sorted position -> input row
    cot: torch.Tensor    # (N, use) f32, unit column stride
    num_rows: int
    y: torch.Tensor      # (N, use) f32: the scanned sorted rows
    end: torch.Tensor    # (num_rows,) int32: a segment's last sorted row, -1 if none
    g: torch.Tensor      # (2, nb * use) f32: the carry's ping-pong buffers
    a: torch.Tensor      # (2, nb) f32
    out: torch.Tensor    # (num_rows, use) f32

    @property
    def nb(self) -> int:
        return self.a.shape[1]

    @property
    def carry(self) -> torch.Tensor:
        """The buffer that holds the carries after the last pass."""
        return self.g[carry_passes(self.nb) % 2]


def prepare(idx: torch.Tensor, cot: torch.Tensor, num_rows: int) -> Work:
    """The sort (torch.sort, stable, on int32 keys) and the kernels'
    outputs and scratch, allocated uninitialised."""
    n, use = cot.shape
    sid, perm = torch.sort(idx.to(torch.int32), stable=True)
    nb = -(-n // BLOCK)
    f32 = dict(dtype=torch.float32, device=cot.device)
    return Work(sid=sid, perm=perm, cot=cot, num_rows=num_rows,
                y=torch.empty((n, use), **f32),
                end=torch.empty(num_rows, dtype=torch.int32, device=cot.device),
                g=torch.empty((2, nb * use), **f32), a=torch.empty((2, nb), **f32),
                out=torch.empty((num_rows, use), **f32))


def _raise_on(err: int, stage: str) -> None:
    if err:
        raise RuntimeError(f"segsum {stage} kernel launch failed: {_build.error_string(err)}")


def launch_scan(w: Work) -> None:
    """(a): -1 into every end, then one CTA a block of 256 sorted rows:
    the rows read through the permutation, 8 log-shift passes, the scanned
    rows and each segment's last row written."""
    n, use = w.cot.shape
    with _build.on_device(w.cot):
        _raise_on(_build.load().tpurt_segsum_scan(
            _ptr(w.sid), _ptr(w.perm), _ptr(w.cot), w.cot.stride(0), n, use, w.num_rows,
            _ptr(w.y), _ptr(w.end), _stream(w.cot.device)), "scan")


def launch_carry(w: Work) -> None:
    """(b): each block's carry, one launch to set up and one a log-shift
    pass, ping-ponging between w.g[0] and w.g[1] (the result in w.carry)."""
    n, use = w.cot.shape
    with _build.on_device(w.cot):
        _raise_on(_build.load().tpurt_segsum_carry(
            _ptr(w.sid), _ptr(w.y), n, use, _ptr(w.g[0]), _ptr(w.g[1]), _ptr(w.a[0]),
            _ptr(w.a[1]), _stream(w.cot.device)), "carry")


def launch_ends(w: Work) -> None:
    """(c): one thread an output element, the end row plus its carry, or 0."""
    use = w.cot.shape[1]
    with _build.on_device(w.cot):
        _raise_on(_build.load().tpurt_segsum_ends(
            _ptr(w.sid), _ptr(w.end), _ptr(w.y), _ptr(w.carry), w.num_rows, use,
            _ptr(w.out), _stream(w.cot.device)), "ends")


def segment_accumulate(idx: torch.Tensor, cot: torch.Tensor,
                       num_rows: int) -> torch.Tensor:
    """out[v] = sum of the rows cot[i] with idx[i] == v, (num_rows, C) f32,
    in one fixed order of additions (tpurt's), so it repeats bit for bit.
    idx (N,) integer in [0, num_rows) (callers clamp; on the card an id
    outside is dropped); cot (N, C) f32 with unit column stride (any row
    stride: the backward passes the first grad_cols columns of a wider
    row).  CUDA tensors go through csrc/segsum.cu, CPU tensors through
    segment_accumulate_ref."""
    dev = cot.device
    if idx.dim() != 1 or cot.dim() != 2 or idx.shape[0] != cot.shape[0]:
        raise ValueError(f"idx must be (N,) and cot (N, C), got {tuple(idx.shape)} "
                         f"and {tuple(cot.shape)}")
    if idx.device != dev:
        raise ValueError(f"idx is on {idx.device}, cot on {dev}")
    if idx.dtype.is_floating_point or idx.dtype == torch.bool:
        raise TypeError(f"idx must be an integer tensor, got {idx.dtype}")
    if dev.type == "cpu":
        return segment_accumulate_ref(idx, cot, num_rows)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if cot.dtype != torch.float32:
        raise TypeError(f"cot must be float32, got {cot.dtype}")
    n, use = cot.shape
    if use and cot.stride(1) != 1:
        raise ValueError("cot must have unit column stride")
    if max(n, num_rows) > MAX_ROWS:
        raise ValueError(f"segment_accumulate takes at most 2^31 - 1 rows and ids, got "
                         f"{n} rows into {num_rows}")
    if n == 0 or use == 0:
        return cot.new_zeros((num_rows, use))
    w = prepare(idx, cot, num_rows)
    launch_scan(w)
    launch_carry(w)
    launch_ends(w)
    LAUNCHES["segsum"] += 1
    return w.out
