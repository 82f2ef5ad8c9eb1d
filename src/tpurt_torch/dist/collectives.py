"""Collectives over a 1-D DeviceMesh, and the fit's overlapped gradient
(counterpart of ``tpurt/dist/collectives.py``).

tpurt writes ``psum`` / ``all_gather`` / ``ppermute`` inside ``shard_map``;
here each rank calls ``torch.distributed`` on the mesh's process group
(NCCL on the card, gloo on the CPU).  A "tree" is a dict of tensors.

``chunked_grad`` is the one scheduling-sensitive piece, as in tpurt: the
rank's rays are split into chunks and each chunk's gradient is all-reduced
asynchronously as soon as that chunk's backward is done, so the reduction
of chunk i overlaps the render of chunk i + 1.  The handles are waited on
before the caller's optimizer step.  COUNTS counts every all-reduce this
module issues (and its bytes) since the last reset_counts(), as the kernel
wrappers count their launches.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpurt_torch.obs.trace import trace_span

COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _all_reduce(x: torch.Tensor, mesh: DeviceMesh, async_op: bool = False):
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_bytes"] += x.numel() * x.element_size()
    return dist.all_reduce(x, group=mesh.get_group(), async_op=async_op)


def peer(mesh: DeviceMesh, shift: int) -> int:
    """The global rank `shift` places along the ring from this rank."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks[(mesh.get_local_rank() + shift) % len(ranks)]


def rank_rows(n: int, mesh: DeviceMesh) -> slice:
    """This rank's contiguous slice of n rows (n a multiple of the mesh)."""
    w = mesh.size()
    if n % w:
        raise ValueError(f"{n} rows do not split over a mesh of {w}; pad first")
    r = mesh.get_local_rank()
    return slice(r * n // w, (r + 1) * n // w)


def psum_tree(tree: dict, mesh: DeviceMesh) -> dict:
    """Every tensor summed over the mesh (new tensors; the tree is kept)."""
    out = {k: v.detach().clone() for k, v in tree.items()}
    for v in out.values():
        _all_reduce(v, mesh)
    return out


def pmean_tree(tree: dict, mesh: DeviceMesh) -> dict:
    return {k: v / mesh.size() for k, v in psum_tree(tree, mesh).items()}


def all_gather_tree(tree: dict, mesh: DeviceMesh) -> dict:
    """Every rank's tensors concatenated along dim 0 in rank order, on every
    rank (tpurt's tiled all_gather).  Bools travel as uint8."""
    out = {}
    for k, v in tree.items():
        x = v.detach().contiguous()
        x = x.to(torch.uint8) if x.dtype == torch.bool else x
        full = x.new_empty((mesh.size() * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(full, x, group=mesh.get_group())
        out[k] = full.bool() if v.dtype == torch.bool else full
    return out


def ppermute_tree(tree: dict, mesh: DeviceMesh) -> dict:
    """Rotate the tree one step around the ring: each rank sends its tensors
    to rank + 1 and receives rank - 1's, every send paired with its receive
    in one batch_isend_irecv (no blocking send before a receive).  At world
    1 the rotation is the identity, as tpurt's ppermute to self is a copy:
    no point-to-point op is issued."""
    if mesh.size() == 1:
        return tree
    group, dst, src = mesh.get_group(), peer(mesh, 1), peer(mesh, -1)
    sent = {k: (v.to(torch.uint8) if v.dtype == torch.bool else v).contiguous()
            for k, v in tree.items()}
    got = {k: torch.empty_like(v) for k, v in sent.items()}
    ops = []
    for k in sent:
        ops.append(dist.P2POp(dist.isend, sent[k], dst, group))
        ops.append(dist.P2POp(dist.irecv, got[k], src, group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return {k: got[k].bool() if tree[k].dtype == torch.bool else got[k] for k in tree}


def chunked_grad(loss_fn: Callable[..., torch.Tensor], params, chunk_args: tuple,
                 n_chunks: int, mesh: DeviceMesh | None = None):
    """Overlapped data-parallel gradient: sum_i all_reduce(grad(loss(params,
    chunk_i))).

    loss_fn(params, *chunk) returns a scalar sum over the chunk, so chunking
    and sharding do not change the total.  params is a tensor or a dict of
    tensors that require grad; chunk_args are tensors whose leading axis (the
    rank's rays) splits evenly into n_chunks.  With a mesh, each chunk's
    gradient and loss travel in one flat buffer in one asynchronous
    all-reduce, issued as soon as that chunk's backward is done: n_chunks
    all-reduces a call.  Returns (loss, grads), summed over the chunks and
    the mesh, grads shaped as params.  Each chunk's forward and backward
    run in the spans tpurt::fit.forward and tpurt::fit.backward."""
    leaves = list(params.values()) if isinstance(params, dict) else [params]
    sizes = [p.numel() for p in leaves]
    pending, total = [], None
    for i in range(n_chunks):
        chunk = tuple(x.reshape(n_chunks, -1, *x.shape[1:])[i] for x in chunk_args)
        with trace_span("tpurt::fit.forward"):
            loss = loss_fn(params, *chunk)
        with trace_span("tpurt::fit.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                              for p, g in zip(leaves, grads)] + [loss.detach().reshape(1)])
        if mesh is not None:
            pending.append((flat, _all_reduce(flat, mesh, async_op=True)))
        else:
            total = flat if total is None else total + flat
    for flat, work in pending:
        work.wait()
        total = flat if total is None else total + flat
    parts = torch.split(total[:-1], sizes)
    grads = [g.reshape(p.shape) for g, p in zip(parts, leaves)]
    out = dict(zip(params, grads)) if isinstance(params, dict) else grads[0]
    return total[-1], out
