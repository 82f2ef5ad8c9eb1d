"""tpurt_torch CLI: render / build-bvh / fit / check-grads / bench
(counterpart of ``tpurt/cli/main.py``, with tpurt's verbs and flags).

Thin wrapper over the api/ layer, on the CUDA device.  ``--shard`` (render,
fit) joins the process group (dist/runtime.init_distributed: torchrun's
environment, or a world-1 group) and passes the mesh over its ranks to the
Renderer or InverseRenderer; only the coordinator writes files:

    torchrun --nproc-per-node 4 -m tpurt_torch.cli.main render --shard --scene sponza

    python -m tpurt_torch.cli.main render --scene cornell --width 256 -o out.png
    python -m tpurt_torch.cli.main build-bvh --scene sponza5m
    python -m tpurt_torch.cli.main fit --scene cornell --steps 50 --perturb 0.03
    python -m tpurt_torch.cli.main check-grads --scene cornell --width 24

    python -m tpurt_torch.cli.main bench --skip-5m --parity

``bench`` runs the port's benchmark (tpurt_torch/bench.py) as tpurt's runs
``bench.py``: --scene, --tris, --width, --height and --method go to it,
and so does every flag of the benchmark's own that follows the verb.
``render --light-samples S --seed K`` adds area light from S points drawn
on the emissive triangles by a generator seeded K.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def _scene(args):
    from tpurt_torch.core.scene import get_scene

    kw = {}
    if args.scene in ("sponza", "sponza5m", "bunny"):
        if args.tris:
            kw["num_tris"] = args.tris
    if args.scene in ("sponza", "sponza5m") and args.width:
        kw["width"], kw["height"] = args.width, args.height or args.width
    scene, cam = get_scene(args.scene, device=args.device, **kw)
    if args.width and args.scene not in ("sponza", "sponza5m"):
        cam = dataclasses.replace(cam, width=args.width, height=args.height or args.width)
    return scene, cam


def _mesh(args):
    """The mesh over every rank with --shard (the process group joined or
    made first), else None."""
    if not args.shard:
        return None
    from tpurt_torch.api.config import DistConfig
    from tpurt_torch.dist.runtime import init_distributed
    from tpurt_torch.dist.shard import make_mesh

    cfg = DistConfig()
    init_distributed(cfg.coordinator, cfg.num_processes, cfg.process_id, device=args.device)
    return make_mesh(args.device)


def _save_image(img: torch.Tensor, path: str) -> None:
    from tpurt_torch.core.math import to_uint8

    if path.endswith(".npy"):
        np.save(path, img.detach().cpu().numpy())
        return
    arr = to_uint8(img).cpu().numpy()
    try:
        from PIL import Image

        Image.fromarray(arr).save(path)
    except ImportError:  # dependency-free binary PPM
        if not path.endswith(".ppm"):
            path += ".ppm"
        with open(path, "wb") as f:
            f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())


def cmd_render(args) -> int:
    from tpurt_torch.api.config import RenderConfig
    from tpurt_torch.api.renderer import Renderer
    from tpurt_torch.dist.runtime import is_coordinator
    from tpurt_torch.obs import get_logger, trace_span

    log = get_logger()
    mesh = _mesh(args)
    scene, cam = _scene(args)
    cfg = RenderConfig(method=args.method, spp=args.spp,
                       light_samples=args.light_samples, light_seed=args.seed)
    with trace_span("render", log=True):
        img = Renderer(scene, cfg, mesh=mesh).render(cam)
        if img.is_cuda:
            torch.cuda.synchronize()
    if not is_coordinator():
        return 0
    _save_image(img, args.out)
    log.info("wrote %s (%dx%d, %d tris)", args.out, cam.width, cam.height, scene.num_tris)
    return 0


def cmd_build_bvh(args) -> int:
    from tpurt_torch.accel.lbvh import build_lbvh
    from tpurt_torch.obs import emit

    scene, _ = _scene(args)

    def build():
        bvh = build_lbvh(scene.tris, leaf_size=args.leaf_size)
        if scene.tris.verts.is_cuda:
            torch.cuda.synchronize()
        return bvh

    build()  # the first build loads the kernels and warms the allocator
    t0 = time.perf_counter()
    build()
    dt = time.perf_counter() - t0
    emit("bvh_build", scene.num_tris / dt, "tris/s", tris=scene.num_tris, seconds=dt)
    return 0


def cmd_fit(args) -> int:
    from tpurt_torch.api.config import FitConfig, RenderConfig
    from tpurt_torch.api.inverse import InverseRenderer
    from tpurt_torch.obs import get_logger
    from tpurt_torch.render.pipeline import render

    log = get_logger()
    mesh = _mesh(args)
    scene, cam = _scene(args)
    rcfg = RenderConfig(method=args.method, soft=True, k_layers=4, sharpness=40.0,
                        band=0.15)
    with torch.no_grad():
        target = render(scene, cam, method=args.method, **rcfg.render_kwargs())
    perturbed = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, verts=scene.tris.verts * (1.0 + args.perturb)))
    inv = InverseRenderer(
        perturbed, cam,
        fit=FitConfig(steps=args.steps, lr=args.lr, ckpt_path=args.ckpt,
                      ckpt_every=args.ckpt_every),
        render=rcfg, mesh=mesh)
    res = inv.fit(target, callback=lambda i, l: log.info("step %d loss %.3e", i, l))
    if not res.losses:
        log.info("fit done: nothing to run (resumed at step %d of %d)", args.steps, args.steps)
        return 0
    log.info("fit done: loss %.3e -> %.3e", res.losses[0], res.losses[-1])
    return 0 if res.losses[-1] < res.losses[0] else 1


def cmd_check_grads(args) -> int:
    """FD gradient gate through any engine (--method): the tree is built
    once and refit inside the loss as the fit step does, so this checks
    the path users train on."""
    from tpurt_torch.api.inverse import refit_tracer
    from tpurt_torch.diff.fdcheck import check_grads_fd
    from tpurt_torch.obs import get_logger
    from tpurt_torch.render.pipeline import make_tracer, render

    log = get_logger()
    scene, cam = _scene(args)
    # generic position: a small seeded jitter, so no face sits on a kink of
    # max(n.l, 0) or of the min-barycentric coverage where no one-sided
    # derivative matches a central difference (tpurt draws it from
    # jax.random; the port from numpy, so the probes land elsewhere)
    jit = np.random.default_rng(9).uniform(-0.015, 0.015, tuple(scene.tris.verts.shape))
    scene = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, verts=scene.tris.verts + torch.tensor(
            jit, dtype=torch.float32, device=scene.tris.verts.device)))
    band, soft_kw = 0.25, dict(soft=True, k_layers=8, sharpness=30.0, band=0.25)
    method = args.method
    tracer0 = make_tracer(scene, method, band=band)

    def loss(verts):
        tris = dataclasses.replace(scene.tris, verts=verts)
        sc = dataclasses.replace(scene, tris=tris)
        tracer = refit_tracer(tracer0, dataclasses.replace(tris, verts=verts.detach()))
        return torch.mean(render(sc, cam, tracer=tracer, **soft_kw) ** 2)

    report = check_grads_fd(loss, scene.tris.verts, max_probes_per_leaf=args.probes)
    log.info("check-grads[%s]: %s", method, report)
    return 0 if report["ok"] else 1


def cmd_bench(args) -> int:
    """The benchmark's main on the verb's device, with the verb's flags that
    were given (--method unless "auto", as tpurt's cmd_bench forwards it)
    and then the benchmark's own flags (args.bench_args)."""
    from tpurt_torch import bench

    argv = ["--device", args.device, "--scene", args.scene]
    for flag in ("tris", "width", "height"):
        if getattr(args, flag):
            argv += [f"--{flag}", str(getattr(args, flag))]
    if args.method != "auto":
        argv += ["--method", args.method]
    return bench.main(argv + args.bench_args)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpurt-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="cornell",
                        help="cornell|bunny|sponza|sponza5m|*.obj|*.ply")
        sp.add_argument("--tris", type=int, default=0)
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--method", default="bvh", help="brute|bvh|binary|wide8")

    sp = sub.add_parser("render", help="render a scene to an image")
    common(sp)
    sp.add_argument("-o", "--out", default="out.png")
    sp.add_argument("--spp", type=int, default=1)
    sp.add_argument("--light-samples", type=int, default=0,
                    help="area-light samples per shading point")
    sp.add_argument("--seed", type=int, default=0,
                    help="seed of the area-light sampler (light_seed)")
    sp.add_argument("--shard", action="store_true",
                    help="shard rays over every rank of the process group")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("build-bvh", help="build the LBVH and report tris/s")
    common(sp)
    sp.add_argument("--leaf-size", type=int, default=8)
    sp.set_defaults(fn=cmd_build_bvh)

    sp = sub.add_parser("fit", help="inverse-render a perturbed scene back to target")
    common(sp)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--perturb", type=float, default=0.02)
    sp.add_argument("--shard", action="store_true",
                    help="data-parallel fit over every rank of the process group")
    sp.add_argument("--ckpt", default=None)
    sp.add_argument("--ckpt-every", type=int, default=50)
    sp.set_defaults(fn=cmd_fit)

    sp = sub.add_parser("check-grads", help="finite-difference gradient gate")
    common(sp)
    sp.add_argument("--probes", type=int, default=8)
    sp.set_defaults(fn=cmd_check_grads)

    sp = sub.add_parser("bench", help="the rays/s benchmark (tpurt_torch.bench; its own "
                                      "flags, such as --skip-5m, follow the verb's)")
    common(sp)
    sp.set_defaults(fn=cmd_bench, scene="sponza", method="auto")
    return p


def main(argv=None, device="cuda") -> int:
    """Run one verb; its scene lives on `device` (the card unless a caller,
    such as a test, asks for the CPU)."""
    import torch.distributed as dist

    parser = build_parser()
    args, rest = parser.parse_known_args(argv)
    if rest and args.cmd != "bench":
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    args.bench_args = rest
    args.device = device
    owns_group = getattr(args, "shard", False) and not dist.is_initialized()
    try:
        return args.fn(args)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
