"""Multi-rank dry run of the port's distributed paths (counterpart of
``__graft_entry__.dryrun_multichip``), and the spawner the tests use.

    python -m tpurt_torch.dist.dryrun --nproc 4 --device cpu

spawns ``--nproc`` ranks (gloo on the CPU, NCCL on cards: one card a rank)
that meet through a ``file://`` rendezvous in a temporary directory, and in
each runs:
- one data-parallel fit step (InverseRenderer with a mesh, grad_chunks 2)
  on cornell 16x16: finite losses;
- the ring render through Renderer(partition="ring") against the
  replicated render of the same sponza scene (at most 0.3% of pixels off
  by more than 2e-3, tpurt's rule);
- one partitioned fit step on the bunny, the partition and this rank's
  packed tree rebuilt in the step from the current vertices, once through
  the ring's "packet" engine (tpurt's dryrun) and once through "binary":
  a finite loss, finite non-zero gradients, vertices moved.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import multiprocessing as mp
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

IMAGE_ATOL, IMAGE_MAX_OFF = 2e-3, 0.003


def _rank_main(fn, rank: int, nproc: int, workdir: str, device: str, args: tuple) -> None:
    from tpurt_torch.dist.runtime import init_distributed
    from tpurt_torch.dist.shard import make_mesh

    # ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * nproc)))
    init_distributed(f"file://{os.path.join(workdir, 'rendezvous')}", nproc, rank,
                     device=device)
    try:
        out = fn(make_mesh(device), *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nproc: int, *args, device: str = "cuda", timeout: float = 300.0,
              workdir: str | None = None) -> list:
    """Run fn(mesh, *args) in nproc spawned ranks, one card each on "cuda"
    (NCCL), CPU processes on "cpu" (gloo), and return each rank's result
    (tensors, numbers, lists and dicts of them), in rank order.  fn
    must be importable by name (a module's top-level function).  A rank that
    fails, or a run past `timeout` seconds, raises; every rank is stopped
    either way."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, nproc, tmp, device, args))
                 for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            if hung:
                raise TimeoutError(f"ranks {hung} still running after {timeout} s")
            failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
            if failed:
                raise RuntimeError(f"ranks exited with codes {failed}")
            return [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(nproc)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()


def dp_fit_step(mesh, device: str) -> dict:
    """One data-parallel fit step on cornell 16x16 (tpurt's dryrun)."""
    from tpurt_torch.api.config import FitConfig, RenderConfig
    from tpurt_torch.api.inverse import InverseRenderer
    from tpurt_torch.core.scene import make_cornell_box
    from tpurt_torch.render.pipeline import render

    scene, cam = make_cornell_box(device=device)
    cam = dataclasses.replace(cam, width=16, height=16)
    rkw = dict(method="bvh", soft=True, k_layers=2, sharpness=40.0, band=0.15)
    with torch.no_grad():
        target = render(scene, cam, **rkw)
    pert = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, verts=scene.tris.verts * 1.02))
    res = InverseRenderer(pert, cam, fit=FitConfig(steps=1, lr=1e-3, grad_chunks=2),
                          render=RenderConfig(**rkw), mesh=mesh).fit(target)
    if res.steps_run != 1 or not all(map(math.isfinite, res.losses)):
        raise RuntimeError(f"data-parallel fit: bad losses {res.losses}")
    return {"losses": res.losses}


def partitioned_ring(mesh, device: str, tris: int, width: int, height: int) -> dict:
    """Renderer(partition="ring") against the replicated render of the same
    sponza scene, by tpurt's image rule."""
    from tpurt_torch.api.config import RenderConfig
    from tpurt_torch.api.renderer import Renderer
    from tpurt_torch.core.scene import make_sponza_scene

    scene, cam = make_sponza_scene(num_tris=tris, width=width, height=height, device=device)
    cfg = RenderConfig(method="wide8")
    ring = Renderer(scene, cfg, mesh=mesh, partition="ring")
    if ring.tracer.method != "ring":
        raise RuntimeError("Renderer(partition='ring') did not build the ring")
    img = ring.render(cam)
    ref = Renderer(scene, cfg).render(cam)
    off = float(((img - ref).abs().amax(dim=-1) > IMAGE_ATOL).float().mean())
    if not bool(torch.isfinite(img).all()) or off > IMAGE_MAX_OFF:
        raise RuntimeError(f"ring render against replicated: {off} of pixels off")
    return {"off_frac": off}


def partitioned_fit(mesh, device: str, engine: str = "packet") -> dict:
    """One differentiable fit step over the partitioned scene: the soft
    render through ring_k_nearest, the partition and this rank's PackedBVH
    rebuilt in the step from the current vertices (no gradient through the
    structure) and walked by the ring engine `engine` ("packet", as tpurt's
    dryrun, or "binary"), d(loss)/d(verts, albedo) through the replicated
    table, one Adam step."""
    from tpurt_torch.core.geometry import Rays
    from tpurt_torch.core.scene import make_bunny_scene
    from tpurt_torch.dist.scene_partition import build_partition_bvhs, partition_scene
    from tpurt_torch.render.camera import gen_primary_rays
    from tpurt_torch.render.pipeline import make_tracer, render_rays, tri_table

    scene, cam = make_bunny_scene(num_tris=600, device=device)
    cam = dataclasses.replace(cam, width=16, height=16)
    band = 0.15
    rkw = dict(soft=True, k_layers=2, sharpness=40.0, band=band, k_occ=4)
    tracer0 = make_tracer(scene, "ring", band=band, mesh=mesh, ring_engine=engine)
    rays = gen_primary_rays(cam)
    with torch.no_grad():
        target = render_rays(tracer0, rays, **rkw)
    params = {"verts": (scene.tris.verts * 1.01).requires_grad_(True),
              "albedo": scene.tris.albedo.clone().requires_grad_(True)}
    opt = torch.optim.Adam(list(params.values()), lr=1e-3)
    tris = dataclasses.replace(scene.tris, verts=params["verts"],
                               albedo=torch.clamp(params["albedo"], 0.0, 1.0))
    frozen = dataclasses.replace(tris, verts=tris.verts.detach(), albedo=tris.albedo.detach())
    part = partition_scene(frozen, mesh.size())
    pbvh = build_partition_bvhs(part, band=band, index=mesh.get_local_rank())
    tr = dataclasses.replace(tracer0, scene=dataclasses.replace(scene, tris=tris), part=part,
                             pbvh=pbvh, table=tri_table(tris))
    loss = torch.sum((render_rays(tr, Rays(o=rays.o, d=rays.d), **rkw) - target) ** 2)
    before = params["verts"].detach().clone()
    opt.zero_grad()
    loss.backward()
    gsum = float(sum(p.grad.abs().sum() for p in params.values()))
    opt.step()
    moved = float((params["verts"].detach() - before).abs().max())
    loss = float(loss.detach())
    if not (math.isfinite(loss) and loss > 0 and 0 < gsum < math.inf and moved > 0):
        raise RuntimeError(f"partitioned fit ({engine}): loss {loss}, |grad| {gsum}, "
                           f"moved {moved}")
    return {"loss": loss, "grad_abs_sum": gsum, "moved": moved}


def dryrun(mesh, device: str, tris: int, width: int, height: int) -> dict:
    return {"dp_fit": dp_fit_step(mesh, device),
            "ring": partitioned_ring(mesh, device, tris, width, height),
            "partitioned_fit": {e: partitioned_fit(mesh, device, e)
                                for e in ("packet", "binary")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) | cpu (gloo)")
    ap.add_argument("--tris", type=int, default=100_000, help="the ring's sponza")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    out = run_ranks(dryrun, args.nproc, args.device, args.tris, args.width, args.height,
                    device=args.device, timeout=args.timeout)
    for r, o in enumerate(out):
        print(f"rank {r}: {o}", flush=True)
    print(f"dryrun({args.nproc}, {args.device}) ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
