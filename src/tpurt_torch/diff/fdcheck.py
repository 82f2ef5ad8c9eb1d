"""Finite-difference gradient check (counterpart of ``tpurt/diff/fdcheck.py``).

The gradient gate of the soft render: autograd's gradient of a scalar loss
against Richardson-extrapolated central differences, on every coordinate of a
small parameter or on a seeded random subset of a large one.  Parameters are
a tensor, a tuple or list of tensors, or a dict of them (leaves in sorted key
order, as tpurt's pytree flattening).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _leaves(params) -> list[torch.Tensor]:
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [params[k] for k in sorted(params)]
    return list(params)


def _rebuild(params, leaves):
    if isinstance(params, torch.Tensor):
        return leaves[0]
    if isinstance(params, dict):
        return dict(zip(sorted(params), leaves))
    return type(params)(leaves)


def fd_grad_at(f: Callable[[Any], torch.Tensor], params, leaf: int,
               flat_index: int, eps: float) -> float:
    """Central finite difference of scalar f along one coordinate."""
    leaves = [x.detach() for x in _leaves(params)]

    def bump(sign):
        new = list(leaves)
        x = new[leaf].clone(memory_format=torch.contiguous_format)
        x.view(-1)[flat_index] += sign * eps
        new[leaf] = x
        return _rebuild(params, new)

    with torch.no_grad():
        fp, fm = float(f(bump(1.0))), float(f(bump(-1.0)))
    return (fp - fm) / (2.0 * eps)


def fd_grad_at_richardson(f, params, leaf: int, flat_index: int, eps: float) -> float:
    """(4 D(eps/2) - D(eps)) / 3: cancels the O(eps^2) term, which the soft
    render's 1/sharpness-scale features make large."""
    d1 = fd_grad_at(f, params, leaf, flat_index, eps)
    d2 = fd_grad_at(f, params, leaf, flat_index, eps * 0.5)
    return (4.0 * d2 - d1) / 3.0


def check_grads_fd(f: Callable[[Any], torch.Tensor], params, *, eps: float = 2e-3,
                   rtol: float = 5e-2, atol: float = 1e-3,
                   max_probes_per_leaf: int = 32, seed: int = 0,
                   verbose: bool = False, richardson: bool = True) -> dict:
    """Compare autograd's gradient of f with central finite differences.

    Returns {ok, max_abs_err, max_rel_err, n_probes, failures}; raises
    AssertionError when a probed coordinate disagrees beyond
    atol + rtol * max(|fd|, |ad|) at eps, eps/2 and eps/4 alike."""
    leaves = [x.detach().requires_grad_(True) for x in _leaves(params)]
    grads = torch.autograd.grad(f(_rebuild(params, leaves)), leaves,
                                allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    rng = np.random.default_rng(seed)
    fd_fn = fd_grad_at_richardson if richardson else fd_grad_at
    failures, max_abs, max_rel, n = [], 0.0, 0.0, 0
    for li, (p, g) in enumerate(zip(leaves, grads)):
        size = p.numel()
        if size <= max_probes_per_leaf:
            idxs = np.arange(size)
        else:
            idxs = rng.choice(size, size=max_probes_per_leaf, replace=False)
        g_flat = g.detach().reshape(-1).cpu().numpy()
        for fi in idxs:
            ad = float(g_flat[fi])
            for e in (eps, eps * 0.5, eps * 0.25):
                # curvature at the 1/sharpness scale: refine eps before
                # declaring a mismatch (a real bug keeps a constant offset)
                fd = fd_fn(f, params, li, int(fi), e)
                err, scale = abs(fd - ad), max(abs(fd), abs(ad))
                if err <= atol + rtol * scale:
                    break
            max_abs = max(max_abs, err)
            if scale > atol:
                max_rel = max(max_rel, err / scale)
            n += 1
            if err > atol + rtol * scale:
                failures.append((li, int(fi), fd, ad, err))
            if verbose:
                print(f"leaf {li} idx {fi}: fd={fd:+.6f} ad={ad:+.6f} err={err:.2e}")
    report = {"ok": not failures, "max_abs_err": max_abs, "max_rel_err": max_rel,
              "n_probes": n, "failures": failures}
    if failures:
        lines = "\n".join(f"  leaf {li} flat[{fi}]: fd={fd:+.6f} ad={ad:+.6f} "
                          f"|err|={err:.3e}" for li, fi, fd, ad, err in failures[:16])
        raise AssertionError(f"gradient mismatch on {len(failures)}/{n} probes "
                             f"(eps={eps}, rtol={rtol}, atol={atol}):\n{lines}")
    return report
