"""Key-value sort of the LBVH build: a plain radix sort and the interface
that picks the route (counterpart of ``tpurt/accel/sort_ref.py``).

Keys are uint32 values held in int64, as the port's Morton codes are
(torch cannot shift uint32 tensors on every backend); values are int32.
``sort_pairs(backend="xla")`` is ``torch.sort(stable=True)``, the route
``build_lbvh`` takes: tpurt's counterpart is XLA's ``lax.sort_key_val``,
not a Pallas kernel, so it stays a library call here.  ``"ref"`` is
``radix_sort_ref``, the executable specification of a stable LSD radix
sort, for tests.
"""

from __future__ import annotations

import torch

RADIX_BITS = 8
RADIX = 1 << RADIX_BITS
_U32 = 0xFFFFFFFF
# Rows of the one-hot rank computed at once (bounds its (rows, RADIX)
# int64 temporary to 32 MB).
_RANK_ROWS = 1 << 14


def _counting_pass(keys: torch.Tensor, vals: torch.Tensor, shift: int):
    """One stable counting-sort pass on digit (keys >> shift) & 0xff: a
    histogram, its exclusive scan (each bucket's first slot) and each
    element's rank among the earlier elements of its bucket, from a running
    one-hot count taken a block of rows at a time."""
    digit = (keys >> shift) & (RADIX - 1)
    hist = torch.bincount(digit, minlength=RADIX)
    bucket_start = torch.cumsum(hist, 0) - hist
    buckets = torch.arange(RADIX, device=keys.device)
    seen = torch.zeros(RADIX, dtype=torch.int64, device=keys.device)
    rank = torch.empty_like(digit)
    for lo in range(0, digit.shape[0], _RANK_ROWS):
        dg = digit[lo:lo + _RANK_ROWS]
        onehot = (dg[:, None] == buckets[None, :]).to(torch.int64)
        within = torch.cumsum(onehot, 0) - 1 + seen[None, :]
        rank[lo:lo + _RANK_ROWS] = within.gather(1, dg[:, None])[:, 0]
        seen += onehot.sum(0)
    dest = bucket_start[digit] + rank
    out_keys = torch.empty_like(keys)
    out_vals = torch.empty_like(vals)
    out_keys[dest] = keys
    out_vals[dest] = vals
    return out_keys, out_vals


def radix_sort_ref(keys: torch.Tensor, vals: torch.Tensor | None = None,
                   num_bits: int = 32):
    """Stable LSD radix sort of uint32 keys (any integer tensor, taken mod
    2^32 as tpurt's cast to uint32 does) and their values, 8 bits a pass.
    Returns (sorted keys as int64, values); values default to the int32
    positions 0..N-1."""
    keys = keys.to(torch.int64) & _U32
    if vals is None:
        vals = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    for shift in range(0, num_bits, RADIX_BITS):
        keys, vals = _counting_pass(keys, vals, shift)
    return keys, vals


def sort_pairs(keys: torch.Tensor, vals: torch.Tensor, backend: str = "xla"):
    """(keys, vals) sorted by key ascending, stably.  backend: "xla"
    (torch.sort, tpurt's name for its library sort) | "ref"."""
    if backend == "xla":
        keys, order = torch.sort(keys, stable=True)
        return keys, vals[order]
    if backend == "ref":
        return radix_sort_ref(keys, vals)
    if backend == "pallas":
        raise ValueError(
            "the Pallas radix sort was retired (docs/RETIRED.md); "
            "use backend='xla'"
        )
    raise ValueError(backend)
