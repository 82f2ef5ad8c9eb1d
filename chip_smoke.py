"""Smoke run of tpurt_torch's hard-render path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):
  device   torch.cuda must be available; the card's name and power limit.
  build    nvcc builds the CUDA kernels from src/tpurt_torch/kernels/csrc.
  scene    the 1M-triangle sponza scene at 1920x1088: scene, LBVH, collapse
           and pack seconds.
  parity   each CUDA kernel against its plain-torch twin on the card, on
           every ray of the Morton-ordered 1920x1088 frame and its shadow
           rays, for the scene's camera and for an overview of the
           courtyard; the twins' full-frame milliseconds.
  subset_timing
           kernel and twin milliseconds on 65,536 of the frame's rays.
  render   render(method="wide8") of the full frame through both kernels,
           with the launch counts of that run.
  golden   cornell 64^2 and bunny-3K 48^2 renders on the card against the
           reference images in tests/golden.
  timing   per-kernel milliseconds (CUDA events) and full-frame rays/s.
  profile  torch.profiler over 5 frames: each kernel's and the torch glue's
           share of device time, the device's idle share; closest8 on
           row-major against Morton-ordered rays.
Then the kernels' JSON line and, last, {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tpurt_torch.accel.bvh8 import (  # noqa: E402
    collapse_wide, pack_wide, tri_rows_bytes, wide_bytes)
from tpurt_torch.accel.lbvh import build_lbvh  # noqa: E402
from tpurt_torch.core.geometry import Camera, Hit, Rays  # noqa: E402
from tpurt_torch.core.scene import (  # noqa: E402
    make_bunny_scene, make_cornell_box, make_sponza_scene)
from tpurt_torch.kernels import _build  # noqa: E402
from tpurt_torch.kernels import traverse8 as k8  # noqa: E402
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm  # noqa: E402
from tpurt_torch.render.pipeline import (  # noqa: E402
    Tracer, hit_surface, render, render_rays, shadow_rays)

NUM_TRIS = 1_000_000
WIDTH, HEIGHT = 1920, 1088
# The twins run over a frame in chunks of this many rays (bounds their
# (rays, 8 * max_rows, 128) f32 row gathers to ~1 GB).
PARITY_CHUNK = 262_144
# Kernel and twin timed side by side on every k-th ray of the frame.
SUBSET_RAYS = 65_536
# A kernel may disagree with its twin on at most this fraction of rays
# (ids / blocked flags); with -fmad=false the two should agree exactly.
MAX_MISMATCH_FRAC = 1e-4
# Where ids agree, t, u, v and the shading outputs must agree to this
# absolute tolerance: the kernel and its twin do the same f32 operations in
# the same order, so they are bit-identical.
MAX_ABS_ERR = 0.0
KERNEL_SRC = "src/tpurt_torch/kernels/csrc/traverse8.cu"
# The 1M scene's own camera faces a clutter box ~0.15 units away (every ray
# hits it and every shadow ray is blocked), so the parity check also runs on
# a view over the courtyard, which exercises deep walks, misses and lit
# points.  It is parity coverage only: no timing is taken on it.
OVERVIEW_EYE, OVERVIEW_TARGET = (0.0, 22.0, 26.0), (0.0, 1.5, 0.0)
REPLACES = {"closest8": "src/tpurt/kernels/traverse8.py:425",
            "occluded8": "src/tpurt/kernels/traverse8.py:653"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kw) -> None:
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def golden_check(img: torch.Tensor, name: str, frac: float, atol: float = 2e-3):
    """tests/golden/test_golden.py's _check: at most `frac` of pixels off by
    more than `atol` in any channel."""
    ref = np.load(os.path.join(HERE, "tests", "golden", name))
    img = img.cpu().numpy()
    if img.shape != ref.shape:
        fail(f"{name}: shape {img.shape} != {ref.shape}")
    bad = float((np.abs(img - ref).max(axis=-1) > atol).mean())
    if bad > frac:
        fail(f"{name}: {bad:.5f} of pixels differ (> {frac})")
    return bad


def morton_rays(cam: Camera) -> Rays:
    """Primary rays of the full frame in Morton pixel order (bench.py's
    order: a warp's rays fall on one small screen tile)."""
    rays = gen_primary_rays(cam)
    perm = torch.as_tensor(pixel_morton_perm(cam.height, cam.width)[0],
                           device=rays.o.device)
    return Rays(o=rays.o[perm].contiguous(), d=rays.d[perm].contiguous())


def rays_slice(rays: Rays, sl) -> Rays:
    return Rays(o=rays.o[sl].contiguous(), d=rays.d[sl].contiguous())


def chunked(fn, n: int):
    """Run fn(lo, hi) -> tuple of tensors over consecutive PARITY_CHUNK-ray
    chunks of n rays.  Returns the outputs concatenated and the device
    milliseconds of the whole loop (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    parts = [fn(lo, min(lo + PARITY_CHUNK, n)) for lo in range(0, n, PARITY_CHUNK)]
    end.record()
    torch.cuda.synchronize()
    return [torch.cat(xs) for xs in zip(*parts)], start.elapsed_time(end)


def parity(view: str, tracer: Tracer, frame: Rays) -> dict:
    """Both kernels against their twins on every ray of the Morton-ordered
    frame and on the shadow rays built from its hits as _shade_layer builds
    them.  The twins run in chunks of the frame (their row gathers are
    (rays, 8 * max_rows, 128) f32); their loop is timed as plain_ms.  Fails
    on more than MAX_MISMATCH_FRAC of ids or blocked flags differing, or on
    any value of an agreeing ray off by more than MAX_ABS_ERR."""
    wide, n = tracer.wide, frame.o.shape[0]
    hk, shk = k8.traverse_wide8(frame, wide, shade_out=True)

    def closest_twin(lo: int, hi: int):
        h, sh = k8.traverse_wide8_ref(rays_slice(frame, slice(lo, hi)), wide,
                                      shade_out=True)
        return (h.t, h.u, h.v, h.tri, *sh)

    ref, plain_c = chunked(closest_twin, n)
    hr, shr = Hit(t=ref[0], u=ref[1], v=ref[2], tri=ref[3]), tuple(ref[4:])
    same = hk.tri == hr.tri
    id_bad = int((~same).sum())
    errs = {k: max_abs(a[same], b[same]) for k, a, b in (
        ("t", hk.t, hr.t), ("u", hk.u, hr.u), ("v", hk.v, hr.v),
        ("albedo", shk[0], shr[0]), ("emission", shk[1], shr[1]),
        ("normal", shk[2], shr[2]))}
    p, nrm, _, _ = hit_surface(tracer, frame, hr, shr)
    sh_rays, t_sh = shadow_rays(tracer.scene, p, nrm, hr.valid)
    n_sh = sh_rays.o.shape[0]
    bk = k8.occluded_wide8(sh_rays, wide, t_sh)
    (br,), plain_o = chunked(lambda lo, hi: (k8.occluded_wide8_ref(
        rays_slice(sh_rays, slice(lo, hi)), wide, t_sh[lo:hi]),), n_sh)
    blk_bad = int((bk != br).sum())
    phase("parity", view=view, rays=n, shadow_rays=n_sh,
          hit_frac=f"{float(hr.valid.float().mean()):.4f}",
          id_mismatches=id_bad, blocked_mismatches=blk_bad,
          blocked_frac=f"{float(br.float().mean()):.4f}",
          **{f"max_abs_{k}": repr(v) for k, v in errs.items()},
          closest8_plain_ms=f"{plain_c:.1f}", occluded8_plain_ms=f"{plain_o:.1f}")
    if id_bad > MAX_MISMATCH_FRAC * n:
        fail(f"closest8 ({view}): {id_bad} id mismatches against its twin")
    if blk_bad > MAX_MISMATCH_FRAC * n_sh:
        fail(f"occluded8 ({view}): {blk_bad} blocked-flag mismatches against its twin")
    for k, v in errs.items():
        if not v <= MAX_ABS_ERR:
            fail(f"closest8 ({view}): max |{k} - twin's| = {v!r} > {MAX_ABS_ERR}")
    return dict(sh_rays=sh_rays, t_sh=t_sh, plain_ms={"closest8": plain_c, "occluded8": plain_o},
                err={"closest8": max(errs.values()), "occluded8": float(blk_bad > 0)})


def subset_timing(wide, frame: Rays, par: dict) -> None:
    """Kernel and twin milliseconds on every k-th ray of the frame
    (SUBSET_RAYS of them) and their shadow rays."""
    n = frame.o.shape[0]
    step = n // SUBSET_RAYS
    sub = rays_slice(frame, slice(None, step * SUBSET_RAYS, step))
    sh = par["sh_rays"]
    keep = torch.arange(0, step * SUBSET_RAYS, step, device=frame.o.device)
    keep = (keep[None] + n * torch.arange(sh.o.shape[0] // n, device=keep.device)[:, None]
            ).reshape(-1)  # the same rays' shadow rays, light-major
    sh_sub, t_sub = rays_slice(sh, keep), par["t_sh"][keep].contiguous()
    ms = {"closest8": cuda_ms(lambda: k8.traverse_wide8(sub, wide, shade_out=True)),
          "occluded8": cuda_ms(lambda: k8.occluded_wide8(sh_sub, wide, t_sub))}
    plain = {"closest8": cuda_ms(lambda: k8.traverse_wide8_ref(sub, wide, shade_out=True),
                                 iters=2, warmup=1),
             "occluded8": cuda_ms(lambda: k8.occluded_wide8_ref(sh_sub, wide, t_sub),
                                  iters=2, warmup=1)}
    phase("subset_timing", rays=SUBSET_RAYS,
          **{f"{k}_ms": f"{ms[k]:.4f}" for k in ms},
          **{f"{k}_plain_ms": f"{plain[k]:.4f}" for k in plain})


def frame_timing(tracer: Tracer, frame: Rays, par: dict) -> dict:
    """Full-frame kernel milliseconds and the whole hard frame's rays/s;
    shading is the frame minus the two kernels."""
    wide, n = tracer.wide, frame.o.shape[0]
    sh_rays, t_sh = par["sh_rays"], par["t_sh"]
    ms = {"closest8": cuda_ms(lambda: k8.traverse_wide8(frame, wide, shade_out=True)),
          "occluded8": cuda_ms(lambda: k8.occluded_wide8(sh_rays, wide, t_sh))}
    total = cuda_ms(lambda: render_rays(tracer, frame))
    phase("timing", rays=n, shadow_rays=sh_rays.o.shape[0],
          closest8_ms=f"{ms['closest8']:.4f}", occluded8_ms=f"{ms['occluded8']:.4f}",
          shading_ms_derived=f"{total - ms['closest8'] - ms['occluded8']:.4f}",
          frame_ms=f"{total:.4f}", rays_per_s=f"{n / (total * 1e-3):.1f}")
    return ms


def profile_frame(tracer: Tracer, cam: Camera, frame: Rays, frames: int = 5) -> None:
    """Where a hard frame's device time goes (torch.profiler over `frames`
    back-to-back render_rays calls): each kernel's share of device time,
    the torch glue's share, and the idle share of the device window (first
    device event's start to the last one's end).  Also closest8 on the
    frame's rays in row-major order against Morton order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render_rays(tracer, frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_rays(tracer, frame)
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    row_major = gen_primary_rays(cam)
    rm_ms = cuda_ms(lambda: k8.traverse_wide8(row_major, tracer.wide, shade_out=True))
    mo_ms = cuda_ms(lambda: k8.traverse_wide8(frame, tracer.wide, shade_out=True))
    if not spans:
        phase("profile", device_time="not measured (the profiler saw no device event)",
              closest8_morton_ms=f"{mo_ms:.4f}", closest8_row_major_ms=f"{rm_ms:.4f}")
        return
    busy, end = 0.0, spans[0][0]
    for s, e in spans:  # union of the device intervals
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    window = end - spans[0][0]
    total = sum(e - s for s, e in spans)
    share = {name: sum(e.time_range.end - e.time_range.start for e in dev_events
                       if f"{name}_kernel" in e.name)
             for name in ("closest8", "occluded8")}
    glue = total - sum(share.values())
    phase("profile", frames=frames, device_window_ms=f"{window / 1e3 / frames:.4f}",
          device_busy_ms=f"{busy / 1e3 / frames:.4f}", idle_share=f"{1 - busy / window:.4f}",
          **{f"{k}_share": f"{v / total:.4f}" for k, v in share.items()},
          glue_share=f"{glue / total:.4f}",
          closest8_morton_ms=f"{mo_ms:.4f}", closest8_row_major_ms=f"{rm_ms:.4f}")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    phase("device", kind=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)

    # -- build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          lib=os.path.relpath(_build.library_path(), HERE))

    # -- scene and acceleration structure, stage by stage ----------------
    (scene, cam), s_scene = sync_time(lambda: make_sponza_scene(
        num_tris=NUM_TRIS, width=WIDTH, height=HEIGHT, device=dev))
    bvh, s_lbvh = sync_time(lambda: build_lbvh(scene.tris))
    topo, s_collapse = sync_time(lambda: collapse_wide(scene.tris, bvh))
    wide, s_pack = sync_time(lambda: pack_wide(scene.tris, bvh, *topo))
    tracer = Tracer(scene=scene, bvh=bvh, wide=wide, method="wide8")
    phase("scene", tris=scene.num_tris, wides=wide.num_wides,
          tri_rows=wide.num_rows, wide_bytes=wide_bytes(wide),
          tri_rows_bytes=tri_rows_bytes(wide), max_stack=wide.max_stack,
          max_rows=wide.max_rows, scene_s=f"{s_scene:.3f}",
          lbvh_s=f"{s_lbvh:.3f}", collapse_s=f"{s_collapse:.3f}",
          pack_s=f"{s_pack:.3f}")

    frame = morton_rays(cam)
    overview = morton_rays(Camera.create(
        eye=OVERVIEW_EYE, target=OVERVIEW_TARGET, fov_y_deg=50.0, width=WIDTH,
        height=HEIGHT, device=dev))
    main_par = parity("main", tracer, frame)
    over_par = parity("overview", tracer, overview)
    subset_timing(wide, frame, main_par)

    # -- the main path: render() through both kernels ----------------------
    k8.reset_launches()
    img, s_render = sync_time(lambda: render(scene, cam, method="wide8",
                                             tracer=tracer))
    launches = dict(k8.LAUNCHES)
    hit_frac = float(k8.traverse_wide8(frame, wide).valid.float().mean())
    finite = bool(torch.isfinite(img).all())
    phase("render", shape=tuple(img.shape), seconds=f"{s_render:.3f}",
          finite=finite, hit_frac=f"{hit_frac:.4f}",
          launches_closest8=launches["closest8"],
          launches_occluded8=launches["occluded8"],
          mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not finite:
        fail("the rendered image is not a finite (H, W, 3) array")
    if not 0.5 < hit_frac <= 1.0:
        fail(f"hit fraction {hit_frac} outside (0.5, 1.0]")
    for name, count in launches.items():
        if count <= 0:
            fail(f"the main path never launched {name}")

    # -- reference images (tpurt's goldens) on the card -------------------
    sc, cm = make_cornell_box(device=dev)
    bad_c = golden_check(render(sc, dataclasses.replace(cm, width=64, height=64),
                                method="wide8"), "cornell_brute_64.npy", 0.003)
    sb, cb = make_bunny_scene(num_tris=3000, device=dev)
    bad_b = golden_check(render(sb, dataclasses.replace(cb, width=48, height=48),
                                method="wide8"), "bunny3k_packet_48.npy", 0.003)
    phase("golden", cornell_wide8_bad=bad_c, bunny3k_wide8_bad=bad_b)

    # -- full-frame timing and where its device time goes -----------------
    frame_ms = frame_timing(tracer, frame, main_par)
    profile_frame(tracer, cam, frame)

    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_SRC,
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": max(main_par["err"][name], over_par["err"][name]),
        "ms": round(frame_ms[name], 4),
        "plain_ms": round(main_par["plain_ms"][name], 4),
        "rays": frame.o.shape[0] if name == "closest8" else main_par["t_sh"].shape[0],
    } for name in ("closest8", "occluded8")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
