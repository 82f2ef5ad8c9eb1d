"""The port's benchmark: primary rays a second on one card (counterpart of
tpurt's ``bench.py``, on the port's engines: ``"wide8"`` for tpurt's
``"pallas8"``, ``"binary"`` for its ``"pallas"``; ``"packet"`` and
``"wave"`` are tpurt's own).

    python -m tpurt_torch.bench                     # on the card: 1M and 5M rows
    python -m tpurt_torch.bench --parity --staged   # plus the kernel parity and staged rows
    python -m tpurt_torch.bench --device cpu --scene sponza --tris 2000 \\
        --width 32 --height 32 --skip-5m            # on the CPU, through the twins
    python -m tpurt_torch.cli.main bench            # the CLI's verb runs this main

Rows, each with its scene's own camera and its rays in Morton pixel order:
- fwd, the headline: the hard render (``render_rays(soft=False)``) of the
  whole frame, by default the 1M sponza at 1920x1088; ``value`` is rays/s;
  ``build_s`` the tracer's build (on the card the first one also builds
  the kernels with nvcc when nothing is built yet), ``compile_s`` the first
  call.
- fwd_bwd: tpurt's table-space step (``fwd_bwd_step``): the refit, then
  over zero-padded chunks of 262,144 rays (131,072 at >= 2M triangles) the
  soft render's loss sum(color^2) and its gradient to the triangle table,
  summed, and one backward from the table to (verts, albedo).
- 5M, on the card unless ``--skip-5m`` (the sponza scene only): the 5M
  sponza at 3840x2160, fwd, fwd_bwd (with its peak bytes) and the ring at
  one partition (``make_tracer(method="ring")`` over a world-1 mesh); each
  prints its own JSON row before the headline.
- ``--staged``: cornell, the bunny and the 1M sponza, fwd and fwd_bwd, and
  a 6-step fit through InverseRenderer; one JSON row each on stderr.
- ``--parity``: each kernel against its twin on the same inputs: closest8,
  occluded8 and knear8 on rays spread over the headline frame, the binary
  and the packet kernels on the bunny; any differing ray fails the row.
- ``--sort-bench``: the build's key-value sort (``accel/sort_ref.py``
  ``sort_pairs("xla")``, torch.sort) of 2^20 and 5 x 2^20 seeded random
  uint32 keys (held in int64, as the Morton codes are) with int32 values
  on the card, 2^14 on the CPU; one row each on stderr with tpurt's keys
  (``compile_s`` is the first call's seconds) and ``sorted``.

Each call is timed on the card by CUDA events around batches of ``--iters``
calls, at least ``--iters`` calls and half a second in all, after a first
call and ``--warmup`` more; on the CPU by the host clock.  A row fails if
its first call's colors, loss or gradients are not finite; fwd_bwd rows
carry that step's loss.  The headline row is the last line of stdout.  Nothing falls back: ``--method auto`` means
``"wide8"``, a kernel that fails to build or launch raises, and a row that
fails writes ``error`` into the headline row, which is printed all the same,
and the exit code is 1.  tpurt's ``vs_baseline`` (a TPU target) and
``timing_suspect`` (its readback calibration) have no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Callable

import numpy as np
import torch

from tpurt_torch.accel.sort_ref import sort_pairs
from tpurt_torch.api.config import FitConfig, RenderConfig
from tpurt_torch.api.inverse import InverseRenderer, refit_tracer
from tpurt_torch.core.geometry import T_MAX, Rays
from tpurt_torch.core.scene import get_scene
from tpurt_torch.dist.collectives import chunked_grad
from tpurt_torch.kernels import packet as kp
from tpurt_torch.kernels import traverse as kb
from tpurt_torch.kernels import traverse8 as k8
from tpurt_torch.obs.trace import profile_to
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm
from tpurt_torch.render.pipeline import (
    Tracer, hit_surface, make_tracer, render, render_rays, shadow_rays, tri_table)

# tpurt's fwd_bwd settings (bench.py's rkw) and its chunk sizes.
SOFT = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
CHUNK, CHUNK_LARGE, LARGE_TRIS = 262_144, 131_072, 2_000_000
MIN_SECONDS = 0.5
# --staged: BASELINE.md's configs 1-3 (tpurt's bench.py _run_staged) and the
# fit of config 4: cornell at FIT_RES^2, verts x 1.02, FIT steps, through
# FIT_METHOD as tpurt's _run_fit_staged pins it (the plain-torch walk).
STAGED = (("1-cornell", "cornell", {}), ("2-bunny", "bunny", {}),
          ("3-sponza1m", "sponza", dict(num_tris=1_000_000, width=1920, height=1088)))
FIT_RES, FIT_PERTURB = 64, 1.02
FIT = dict(steps=6, lr=1e-3, grad_chunks=2)
FIT_METHOD = "bvh"
# --sort-bench: tpurt's key counts on a chip and on the CPU.
SORT_SIZES, SORT_SIZES_CPU = (1 << 20, 5 << 20), (1 << 14,)
# --parity: at most PARITY_RAYS rays, evenly strided over the headline frame
# and over the bunny's (PARITY_BUNNY, its 512x512 camera); for the packet
# kernels the bunny frame's first PARITY_RAYS.
PARITY_RAYS = 65_536
PARITY_BUNNY = dict(num_tris=70_000)
# --parity's kernels of each engine: the module of their wrappers, then
# (kernel, wrapper) for the closest-hit, any-hit and k-nearest kernel; each
# twin is the wrapper's name + "_ref".
PARITY_CALLS = {
    "wide8": (k8, (("closest8", "traverse_wide8"), ("occluded8", "occluded_wide8"),
                   ("knear8", "k_nearest_wide8"))),
    "binary": (kb, (("closest_bin", "traverse_packed"), ("occluded_bin", "occluded_packed"),
                    ("knear_bin", "k_nearest_ids_packed"))),
    "packet": (kp, (("packet_closest", "traverse_packet"), ("packet_occluded", "occluded_packet"),
                    ("packet_knear", "k_nearest_ids_packet")))}


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_calls(fn: Callable, n_rays: int, iters: int, warmup: int, dev: torch.device,
               min_seconds: float = MIN_SECONDS) -> tuple[float, float, float, object]:
    """(rays/s, ms a call, compile_s, the first call's output) of fn(): the
    first call timed alone (compile_s), `warmup` more, then batches of
    `iters` calls until at least `iters` calls and `min_seconds` (or 100
    batches) have run; on the card CUDA events bracket each batch, on the
    CPU the host clock does."""
    t0 = time.perf_counter()
    first = fn()
    _sync(dev)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn()
    _sync(dev)
    done, ms = 0, 0.0
    while ms < 1e3 * min_seconds and done < 100 * iters:
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms += start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms += 1e3 * (time.perf_counter() - t0)
        done += iters
    return n_rays / (ms / 1e3 / done), ms / done, compile_s, first


def frame_rays(cam) -> tuple[torch.Tensor, torch.Tensor]:
    """The camera's primary rays (o, d), each (H*W, 3), in Morton pixel
    order (tpurt's bench order: a warp's rays fall on one screen tile)."""
    rays = gen_primary_rays(cam)
    perm = torch.as_tensor(pixel_morton_perm(cam.height, cam.width)[0], device=rays.o.device)
    return rays.o[perm].contiguous(), rays.d[perm].contiguous()


def build(scene, method: str, band: float = 0.0, **kw) -> tuple[Tracer, float]:
    """(tracer, build seconds), the build synchronised."""
    dev = scene.tris.verts.device
    _sync(dev)
    t0 = time.perf_counter()
    tracer = make_tracer(scene, method, band=band, **kw)
    _sync(dev)
    return tracer, time.perf_counter() - t0


def fwd_bwd_step(tracer: Tracer, o: torch.Tensor, d: torch.Tensor, chunk: int) -> Callable:
    """tpurt's bench fwd_bwd step (bench.py run_one, mode "fwd_bwd") on flat
    rays (o, d): step() -> (loss, {"verts": grad, "albedo": grad}).

    The rays are zero-padded to whole chunks, as tpurt pads them with
    jnp.pad: a zero ray never hits, so it adds the background's square to
    the loss and nothing to the gradients (tpurt's turn NaN, ROADMAP P7).
    Each step: the (T, 15) table of (verts, albedo); the tree
    refit to them (refit_tracer: for "wide8" refit_wide_direct from the
    stop-gradient table); per chunk, loss sum(color^2) of the soft render
    (SOFT) and its gradient to a detached copy of the table, summed over
    the chunks (dist/collectives.chunked_grad); then one backward from the
    table to (verts, albedo)."""
    pad = (-o.shape[0]) % chunk
    o, d = (torch.nn.functional.pad(x, (0, 0, 0, pad)) for x in (o, d))
    tris0 = tracer.scene.tris

    def step():
        verts = tris0.verts.detach().requires_grad_(True)
        albedo = tris0.albedo.detach().requires_grad_(True)
        table = tri_table(dataclasses.replace(tris0, verts=verts, albedo=albedo))
        leaf = table.detach().requires_grad_(True)
        frozen = dataclasses.replace(tris0, verts=verts.detach(), albedo=albedo.detach())
        tr = refit_tracer(tracer, frozen, table=leaf.detach())
        tr = dataclasses.replace(tr, scene=dataclasses.replace(tracer.scene, tris=frozen))

        def chunk_loss(tab, oc, dc):
            colors = render_rays(dataclasses.replace(tr, table=tab), Rays(o=oc, d=dc), **SOFT)
            return torch.sum(colors * colors)

        loss, tgrad = chunked_grad(chunk_loss, leaf, (o, d), o.shape[0] // chunk)
        gv, ga = torch.autograd.grad(table, (verts, albedo), tgrad)
        return loss, {"verts": gv, "albedo": ga}

    return step


def run_one(scene, cam, method: str, mode: str, iters: int, warmup: int,
            profile_dir: str | None = None) -> dict:
    """One (scene, method, mode) row over the whole frame: mode "fwd" (the
    hard render) or "fwd_bwd" (fwd_bwd_step; the tracer built with the soft
    band); peak_bytes is the card's peak allocation over the row (0 on the
    CPU); raises if the first call's colors, loss or gradients are not
    finite.  profile_dir: a torch.profiler trace of 3 more calls there."""
    dev = scene.tris.verts.device
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    soft = mode == "fwd_bwd"
    tracer, build_s = build(scene, method, band=SOFT["band"] if soft else 0.0)
    log(f"build: {build_s:.2f}s engine_ran={tracer.method}")
    o, d = frame_rays(cam)
    n = o.shape[0]
    if soft:
        chunk = CHUNK_LARGE if scene.num_tris >= LARGE_TRIS else CHUNK
        fn = fwd_bwd_step(tracer, o, d, min(chunk, n))
    else:
        rays = Rays(o=o, d=d)

        def fn():
            with torch.no_grad():
                return render_rays(tracer, rays)
    rays_per_s, ms, compile_s, first = time_calls(fn, n, iters, warmup, dev)
    outputs = [first[0], *first[1].values()] if soft else [first]
    if not all(bool(torch.isfinite(x).all()) for x in outputs):
        raise FloatingPointError(f"{mode}: a color, loss or gradient is not finite")
    if profile_dir:
        with profile_to(profile_dir):
            for _ in range(3):
                fn()
        log(f"profiler trace written to {profile_dir}")
    log(f"{method}/{mode}: compile {compile_s:.1f}s, {ms:.3f} ms / {n} rays "
        f"= {rays_per_s / 1e6:.2f}M rays/s")
    return {"rays_per_s": rays_per_s, "engine_ran": tracer.method, "bench_rays": n,
            "build_s": round(build_s, 3), "compile_s": round(compile_s, 2),
            "ms_per_call": round(ms, 4), **({"loss": float(first[0])} if soft else {}),
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0}


def run_5m(args, row: dict, dev: torch.device) -> None:
    """BASELINE config 5 on one card: the 5M sponza at 3840x2160, fwd,
    fwd_bwd and the ring at one partition (world 1); each prints its own
    row and mirrors its numbers into the headline row (*_5m keys)."""
    scene, cam = get_scene("sponza5m", device=dev)
    tris = scene.num_tris
    base = dict(scene="sponza5m", tris=tris, width=cam.width, height=cam.height)
    res = run_one(scene, cam, args.method, "fwd", iters=2, warmup=1)
    emit_row(metric="primary_rays_per_s_per_chip_fwd", value=res["rays_per_s"], **base,
             method=args.method, engine_ran=res["engine_ran"], bench_rays=res["bench_rays"],
             build_s=res["build_s"], compile_s=res["compile_s"],
             ms_per_frame=res["ms_per_call"])
    row.update(value_5m=res["rays_per_s"], tris_5m=tris, ms_per_frame_5m=res["ms_per_call"],
               build_s_5m=res["build_s"], engine_ran_5m=res["engine_ran"])
    res = run_one(scene, cam, args.method, "fwd_bwd", iters=1, warmup=1)
    emit_row(metric="primary_rays_per_s_per_chip_fwd_bwd", value=res["rays_per_s"], **base,
             method=args.method, engine_ran=res["engine_ran"], bench_rays=res["bench_rays"],
             ms_per_frame=res["ms_per_call"], peak_bytes=res["peak_bytes"],
             loss=res["loss"], grad_params="verts+albedo")
    row.update(value_5m_fwd_bwd=res["rays_per_s"], ms_per_frame_5m_fwd_bwd=res["ms_per_call"],
               peak_bytes_5m_fwd_bwd=res["peak_bytes"])
    rps, ms, compile_s, build_s = run_ring(scene, cam)
    emit_row(metric="primary_rays_per_s_per_chip_fwd", value=rps, **base,
             method="ring", engine_ran="ring+wide8", parts=1, build_s=round(build_s, 3),
             compile_s=round(compile_s, 2), ms_per_frame=round(ms, 4))
    row.update(value_5m_ring=rps, ms_per_frame_5m_ring=round(ms, 4))


def run_ring(scene, cam) -> tuple[float, float, float, float]:
    """The hard frame through make_tracer(method="ring") over a mesh of
    this process's group (a world-1 group made here, and destroyed after,
    when there is none): (rays/s, ms a frame, compile_s, build_s)."""
    import torch.distributed as dist

    from tpurt_torch.dist.runtime import init_distributed
    from tpurt_torch.dist.shard import make_mesh

    dev = scene.tris.verts.device
    owns = not dist.is_initialized()
    init_distributed(device=dev.type)
    try:
        tracer, build_s = build(scene, "ring", mesh=make_mesh(dev.type))
        o, d = frame_rays(cam)
        rays = Rays(o=o, d=d)

        def fn():
            with torch.no_grad():
                return render_rays(tracer, rays)
        rps, ms, compile_s, img = time_calls(fn, o.shape[0], 2, 1, dev)
        if not bool(torch.isfinite(img).all()):
            raise FloatingPointError("ring: a color is not finite")
    finally:
        if owns:
            dist.destroy_process_group()
    log(f"5M ring (1 part, wide8): build {build_s:.1f}s, {ms:.2f} ms/frame "
        f"= {rps / 1e6:.2f}M rays/s")
    return rps, ms, compile_s, build_s


def run_staged(args, dev: torch.device) -> None:
    """STAGED configs fwd and fwd_bwd through args.method, then the fit
    through FIT_METHOD; one row each on stderr."""
    for name, sc_name, kw in STAGED:
        scene, cam = get_scene(sc_name, device=dev, **kw)
        for mode in ("fwd", "fwd_bwd"):
            r = run_one(scene, cam, args.method, mode, args.iters, args.warmup)
            emit_row(sys.stderr, staged_config=name, mode=mode, method=args.method, **r)
    scene, cam = get_scene("cornell", device=dev)
    cam = dataclasses.replace(cam, width=FIT_RES, height=FIT_RES)
    rcfg = RenderConfig(method=FIT_METHOD, soft=True, k_layers=4, sharpness=40.0, band=0.08)
    with torch.no_grad():
        target = render(scene, cam, method=FIT_METHOD, **rcfg.render_kwargs())
    perturbed = dataclasses.replace(scene, tris=dataclasses.replace(
        scene.tris, verts=scene.tris.verts * FIT_PERTURB))
    inv = InverseRenderer(perturbed, cam, fit=FitConfig(**FIT), render=rcfg)
    t0 = time.perf_counter()
    inv.fit(target, steps=1)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = inv.fit(target, steps=FIT["steps"] - 1)
    _sync(dev)
    dt = (time.perf_counter() - t0) / (FIT["steps"] - 1)
    emit_row(sys.stderr, staged_config="4-fit", method=FIT_METHOD,
             engine_ran=inv.tracer0.method,
             steps_per_s=round(1.0 / dt, 3), rays_per_s_fwd_bwd_equiv=round(cam.num_pixels / dt, 1),
             compile_s=round(compile_s, 2), final_loss=res.losses[-1])


def run_sort_bench(args, dev: torch.device) -> None:
    """tpurt's sort bench on the port's route: sort_pairs("xla") of seeded
    random uint32 keys and their int32 positions, at SORT_SIZES on the card
    (SORT_SIZES_CPU on the CPU); a row each on stderr.  Fails unless the
    first call's keys are in order and its values the permutation that
    puts them there."""
    rng = np.random.default_rng(0)
    for n in SORT_SIZES if dev.type == "cuda" else SORT_SIZES_CPU:
        keys = torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint32).astype(np.int64))
        keys = keys.to(dev)
        vals = torch.arange(n, dtype=torch.int32, device=dev)
        keys_s, ms, compile_s, (sk, sv) = time_calls(
            lambda: sort_pairs(keys, vals, backend="xla"), n, args.iters, args.warmup, dev)
        ok = bool((sk[1:] >= sk[:-1]).all()) and torch.equal(keys[sv.long()], sk)
        ok = ok and torch.equal(torch.sort(sv).values, vals)
        emit_row(sys.stderr, sort_bench="xla", keys=n, ms=round(ms, 3),
                 mkeys_per_s=round(keys_s / 1e6, 1), compile_s=round(compile_s, 2),
                 sorted=ok)
        if not ok:
            raise RuntimeError(f"sort_pairs at {n} keys did not sort them")


def _strided(o: torch.Tensor, d: torch.Tensor) -> Rays:
    step = max(1, o.shape[0] // PARITY_RAYS)
    return Rays(o=o[::step][:PARITY_RAYS].contiguous(), d=d[::step][:PARITY_RAYS].contiguous())


def _leading(o: torch.Tensor, d: torch.Tensor) -> Rays:
    """The frame's first PARITY_RAYS rays: whole packets of the Morton
    frame, as the packet engine walks them (which rays share a packet is
    part of its result, and strided rays make packets no caller makes)."""
    return Rays(o=o[:PARITY_RAYS].contiguous(), d=d[:PARITY_RAYS].contiguous())


def _hits_differ(a, b) -> int:
    """Rays whose closest hit differs in id or in any bit of t, u, v."""
    bits = lambda h: torch.stack([h.t.view(torch.int32), h.u.view(torch.int32),  # noqa: E731
                                  h.v.view(torch.int32), h.tri], dim=-1)
    return int((bits(a) != bits(b)).any(dim=-1).sum())


def _both(mod, wrapper: str, *args, **kw) -> tuple:
    """A kernel wrapper of `mod` and its twin (the same name + "_ref") on
    the same inputs."""
    return getattr(mod, wrapper)(*args, **kw), getattr(mod, wrapper + "_ref")(*args, **kw)


def parity_counts(engine: str, scene, rays: Rays) -> dict:
    """engine's three kernels (PARITY_CALLS) against their twins on the same
    rays: the closest hit (hard tree), the any-hit flag of its shadow rays,
    and the k = 4 nearest band hits (the soft tree, band SOFT["band"]),
    each as the count of rays that differ."""
    mod, ((c, closest), (o, occluded), (k, knear)) = PARITY_CALLS[engine]
    field = "wide" if engine == "wide8" else "packed"
    hard = make_tracer(scene, engine)
    tree = getattr(hard, field)
    soft_tree = getattr(make_tracer(scene, engine, band=SOFT["band"]), field)
    with torch.no_grad():
        hit, ref = _both(mod, closest, rays, tree)
        p, n, _, _ = hit_surface(hard, rays, ref)
        sh, t_sh = shadow_rays(scene, p, n, ref.valid)
        occ = _both(mod, occluded, sh, tree, t_sh)
        ids = _both(mod, knear, rays, soft_tree, SOFT["k_layers"], SOFT["band"], t_max=T_MAX)
    return {c: _hits_differ(hit, ref), o: int((occ[0] != occ[1]).sum()),
            k: int((ids[0] != ids[1]).any(dim=-1).sum())}


def run_parity(scene, cam, dev: torch.device) -> dict:
    """--parity: the wide8 kernels on the headline frame's rays, the binary
    and the packet kernels on the bunny's, against their twins on the same
    device; the row on stderr; raises on any differing ray."""
    bscene, bcam = get_scene("bunny", device=dev, **PARITY_BUNNY)
    out = {"parity": dev.type}
    for engine, sc, cm in (("wide8", scene, cam), ("binary", bscene, bcam),
                           ("packet", bscene, bcam)):
        rays = _leading(*frame_rays(cm)) if engine == "packet" else _strided(*frame_rays(cm))
        out[f"rays_{engine}"] = rays.o.shape[0]
        out.update(parity_counts(engine, sc, rays))
    emit_row(sys.stderr, **out)
    bad = {k: v for k, v in out.items() if k in k8.LAUNCHES | kb.LAUNCHES | kp.LAUNCHES and v}
    if bad:
        raise RuntimeError(f"kernels differ from their twins: {bad}")
    return out


def emit_row(stream=None, **row) -> None:
    print(json.dumps(row), file=stream or sys.stdout, flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m tpurt_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="sponza", help="cornell|bunny|sponza|*.obj|*.ply")
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1088)
    ap.add_argument("--method", default="auto", help="auto (wide8)|wide8|binary|packet|wave|bvh|brute")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    ap.add_argument("--skip-5m", action="store_true",
                    help="skip the 5M sponza rows (they run on the card only)")
    ap.add_argument("--staged", action="store_true",
                    help="also the staged configs 1-4 (rows on stderr)")
    ap.add_argument("--parity", action="store_true",
                    help="each kernel against its twin on this device (a row on stderr)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of 3 headline calls there")
    ap.add_argument("--sort-bench", action="store_true",
                    help="also time the build's key-value sort (sort_pairs) at 1M and 5M "
                         "keys (2^14 on the CPU; rows on stderr)")
    return ap


def main(argv=None) -> int:
    """Run the rows; print the headline row last on stdout.  Returns 0, or 1
    when a row failed (its error is in the headline row)."""
    args = build_parser().parse_args(argv)
    if args.method == "auto":
        args.method = "wide8"
    dev = torch.device(args.device)
    row = {"metric": "primary_rays_per_s_per_chip_fwd", "value": 0.0, "unit": "rays/s",
           "method": args.method}
    try:
        row["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        log(f"device: {row['device']}")
        kw = {}
        if args.scene == "sponza":
            kw = dict(num_tris=args.tris, width=args.width, height=args.height)
        scene, cam = get_scene(args.scene, device=dev, **kw)
        log(f"scene={args.scene} tris={scene.num_tris} frame_rays={cam.num_pixels}")
        res = run_one(scene, cam, args.method, "fwd", args.iters, args.warmup,
                      profile_dir=args.profile_dir)
        row.update(value=res["rays_per_s"], engine_ran=res["engine_ran"], scene=args.scene,
                   tris=scene.num_tris, bench_rays=res["bench_rays"], build_s=res["build_s"],
                   compile_s=res["compile_s"], ms_per_call=res["ms_per_call"])
        res = run_one(scene, cam, args.method, "fwd_bwd", args.iters, args.warmup)
        row.update(value_fwd_bwd=res["rays_per_s"], method_fwd_bwd=args.method,
                   engine_ran_fwd_bwd=res["engine_ran"], ms_per_call_fwd_bwd=res["ms_per_call"],
                   bench_rays_fwd_bwd=res["bench_rays"], loss_fwd_bwd=res["loss"],
                   grad_params="verts+albedo")
        if args.parity:
            row["parity"] = run_parity(scene, cam, dev)
        del scene
        if not args.skip_5m and args.scene == "sponza" and dev.type == "cuda":
            run_5m(args, row, dev)
        if args.staged:
            run_staged(args, dev)
        if args.sort_bench:
            run_sort_bench(args, dev)
    except Exception as e:  # the row's error goes into the headline row
        traceback.print_exc()
        row["error"] = f"{type(e).__name__}: {e}"[:500]
    emit_row(**row)
    return 1 if "error" in row else 0


if __name__ == "__main__":
    sys.exit(main())
