"""Smoke run of tpurt_torch on one NVIDIA GPU: the hard render and the fit
step of the 1M-triangle sponza scene through the hand-written CUDA kernels.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero and prints no result):
  device   torch.cuda must be available; the card's name and power limit.
  build    nvcc builds the CUDA kernels from src/tpurt_torch/kernels/csrc.
  scene    the 1M-triangle sponza scene at 1920x1088: scene, LBVH, collapse
           and pack seconds (band 0, the hard render's tree).
  parity   closest8 and occluded8 against their plain-torch twins on the
           card, on every ray of the Morton-ordered 1920x1088 frame and its
           shadow rays, for the scene's camera and for an overview of the
           courtyard; the twins' full-frame milliseconds and (main view)
           their walk counts, from which the kernels' bounds are computed.
  subset_timing
           kernel and twin milliseconds on 65,536 of the frame's rays.
  scene_band
           the band-0.08 tree of the same scene (the soft path's).
  knear_parity
           knear8 against its twin on every ray of both views: k = 4 on the
           primary rays (t_max = T_MAX) and k = 8 on the shadow-candidate
           rays from layer 0's points (t_max = 2 x the segment), as the soft
           render calls it; kernel and twin full-frame ms, walk counts.
  render   render(method="wide8") of the full frame through closest8 and
           occluded8, with the launch counts of that run.
  golden   cornell 64^2 and bunny-3K 48^2 renders on the card against the
           reference images in tests/golden.
  timing   per-kernel milliseconds (CUDA events) and full-frame rays/s.
  profile  torch.profiler over 5 hard frames: each kernel's and the torch
           glue's share of device time, the device's idle share; closest8 on
           row-major against Morton-ordered rays.
  fit      InverseRenderer.fit: 3 Adam steps of verts and albedo on the 1M
           scene at 1920x1088 (soft, k_layers 4, k_occ 8, 8 ray chunks)
           toward the albedo x 0.8 render; step seconds, fwd+bwd rays/s,
           losses, gradient norms, peak memory, the launch counts of the fit.
  fit_pieces
           knear8 as the fit calls it (the step's refit tree, row-major
           chunks of 261,120 rays): both calls on chunk 0 against the twin
           with their bounds (as knear_parity view=fit_chunk0), and each
           call's kernel ms summed over the 8 chunks; the refit's ms.
  fit_check
           cornell 32^2 soft on the card: wide8 image against brute, wide8
           gradients against the same code on the CPU, finite differences,
           and a 5-step albedo fit whose loss falls.
  profile_fit
           torch.profiler over one fit step: the device-time shares of
           knear8, the backward (index_add_/scatter kernels and the rest),
           the refit and the forward glue; the device's idle share.
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
    collapse_wide, pack_wide, refit_wide_direct, tri_rows_bytes, wide_bytes)
from tpurt_torch.accel.lbvh import build_lbvh  # noqa: E402
from tpurt_torch.api.config import FitConfig, RenderConfig  # noqa: E402
from tpurt_torch.api.inverse import InverseRenderer  # noqa: E402
from tpurt_torch.core.geometry import T_MAX, Camera, Hit, PointLight, Rays  # noqa: E402
from tpurt_torch.core.scene import (  # noqa: E402
    make_bunny_scene, make_cornell_box, make_sponza_scene)
from tpurt_torch.kernels import _build  # noqa: E402
from tpurt_torch.kernels import traverse8 as k8  # noqa: E402
from tpurt_torch.render.camera import gen_primary_rays, pixel_morton_perm  # noqa: E402
from tpurt_torch.diff.fdcheck import check_grads_fd  # noqa: E402
from tpurt_torch.render.pipeline import (  # noqa: E402
    Tracer, hit_surface, make_tracer, occluder_rays, render, render_rays,
    shadow_rays, soft_surface, tri_table)

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
            "occluded8": "src/tpurt/kernels/traverse8.py:653",
            "knear8": "src/tpurt/kernels/traverse8.py:775"}
# The soft path's settings (bench.py's fwd_bwd row): layers, edge sharpness,
# barycentric band, candidate occluders per (point, light).
SOFT = dict(soft=True, k_layers=4, sharpness=40.0, band=0.08, k_occ=8)
BAND = SOFT["band"]
FIT_STEPS, FIT_CHUNKS, FIT_LR = 3, 8, 1e-2
# [fit_check]: tpurt's gradient-gate settings (tests/grad/test_fdcheck.py)
# on cornell in generic position (seeded vertex jitter, off-axis light).
GATE = dict(soft=True, k_layers=8, sharpness=30.0, band=0.25, k_occ=8)
GATE_RES = 32
# Finite differences run at tpurt's own FD-gate resolution: at 32^2 the
# probe seed 1 picks (vertex 34, x) sits within eps = 1e-3 of a kink of the
# soft model, on brute and wide8 alike (the CPU twins, this scene: FD at
# eps 1e-4 agrees with autograd to 0.4%, at 1e-3 it does not).
FD_RES = 24
# wide8 against brute image: tpurt's engine threshold, atol on >= 99.7% of
# pixels.
IMAGE_ATOL, IMAGE_MIN_FRAC = 2e-3, 0.997
# wide8 gradients on the card against the same code on the CPU: atomics sum
# in another order and CUDA's exp, sqrt and division round differently, so
# they agree to this fraction of the largest gradient.
GRAD_DEVICE_RTOL = 1e-4
# The card's peak rates (NVIDIA's H100 SXM data sheet, 700 W): f32 outside
# the tensor cores and HBM bandwidth.  A bound is the larger of bytes over
# the rate and operations over the peak.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Operations per test, read off traverse8.cu: a child slab test is 6 mul,
# 6 sub, 6 min/max per axis pair, 3 max, 3 min and a compare; a
# Möller–Trumbore test is 47 adds, multiplies and one division.
SLAB_OPS, MT_OPS = 25, 47
NODE_BYTES, ROW_BYTES = 256, 512


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


def parity(view: str, tracer: Tracer, frame: Rays, count: bool = False) -> dict:
    """Both kernels against their twins on every ray of the Morton-ordered
    frame and on the shadow rays built from its hits as _shade_layer builds
    them.  The twins run in chunks of the frame (their row gathers are
    (rays, 8 * max_rows, 128) f32); their loop is timed as plain_ms.  Fails
    on more than MAX_MISMATCH_FRAC of ids or blocked flags differing, or on
    any value of an agreeing ray off by more than MAX_ABS_ERR.  count: run
    the twins once more, untimed, counting their walks for the bounds."""
    wide, n = tracer.wide, frame.o.shape[0]
    hk, shk = k8.traverse_wide8(frame, wide, shade_out=True)

    def closest_twin(lo: int, hi: int, stats=None):
        h, sh = k8.traverse_wide8_ref(rays_slice(frame, slice(lo, hi)), wide,
                                      shade_out=True, stats=stats)
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
    def occluded_twin(lo: int, hi: int, stats=None):
        return (k8.occluded_wide8_ref(rays_slice(sh_rays, slice(lo, hi)), wide,
                                      t_sh[lo:hi], stats=stats),)

    (br,), plain_o = chunked(occluded_twin, n_sh)
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
    out = dict(sh_rays=sh_rays, t_sh=t_sh,
               plain_ms={"closest8": plain_c, "occluded8": plain_o},
               err={"closest8": max(errs.values()), "occluded8": float(blk_bad > 0)})
    if count:
        out["bound"] = {"closest8": bound(counted(closest_twin, n), n, 24, 52),
                        "occluded8": bound(counted(occluded_twin, n_sh), n_sh, 28, 1)}
        for name, b in out["bound"].items():
            phase("bound", view=view, kernel=name, **b)
    return out


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


def device_spans(prof):
    """A profile's device kernels: (events, busy, window, total) in µs, where
    busy is the union of their intervals, window runs from the first one's
    start to the last one's end and total sums their durations."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        return events, 0.0, 0.0, 0.0
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return events, busy, end - spans[0][0], sum(e - s for s, e in spans)


def profile_frame(tracer: Tracer, cam: Camera, frame: Rays, frames: int = 5) -> None:
    """Where a hard frame's device time goes (torch.profiler over `frames`
    back-to-back render_rays calls): each kernel's share of device time,
    the torch glue's share, and the idle share of the device window (first
    device event's start to the last one's end).  Also closest8 on the
    frame's rays in row-major order against Morton order."""
    from torch.profiler import ProfilerActivity, profile

    render_rays(tracer, frame)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            render_rays(tracer, frame)
        torch.cuda.synchronize()
    dev_events, busy, window, total = device_spans(prof)
    row_major = gen_primary_rays(cam)
    rm_ms = cuda_ms(lambda: k8.traverse_wide8(row_major, tracer.wide, shade_out=True))
    mo_ms = cuda_ms(lambda: k8.traverse_wide8(frame, tracer.wide, shade_out=True))
    if not dev_events:
        phase("profile", device_time="not measured (the profiler saw no device event)",
              closest8_morton_ms=f"{mo_ms:.4f}", closest8_row_major_ms=f"{rm_ms:.4f}")
        return
    share = {name: sum(e.time_range.end - e.time_range.start for e in dev_events
                       if f"{name}_kernel" in e.name)
             for name in ("closest8", "occluded8")}
    glue = total - sum(share.values())
    phase("profile", frames=frames, device_window_ms=f"{window / 1e3 / frames:.4f}",
          device_busy_ms=f"{busy / 1e3 / frames:.4f}", idle_share=f"{1 - busy / window:.4f}",
          **{f"{k}_share": f"{v / total:.4f}" for k, v in share.items()},
          glue_share=f"{glue / total:.4f}",
          closest8_morton_ms=f"{mo_ms:.4f}", closest8_row_major_ms=f"{rm_ms:.4f}")


def counted(twin, n: int) -> dict:
    """A twin's walk counts over all n rays, from an untimed pass in
    PARITY_CHUNK chunks (twin(lo, hi, stats) accumulates into stats)."""
    stats = {}
    for lo in range(0, n, PARITY_CHUNK):
        twin(lo, min(lo + PARITY_CHUNK, n), stats)
    return k8.walk_counts(stats)


def bound(counts: dict, n_rays: int, in_bytes: int, out_bytes: int) -> dict:
    """The least time the card could take for a walk kernel's work on this
    run's data: the larger of its bytes over PEAK_BYTES_S (each ray's inputs
    read and outputs written once, each distinct node record and leaf row
    the walks touch read once) and its operations over PEAK_F32_FLOPS (8
    slab tests per node visit, 8 Möller–Trumbore tests per leaf row), from
    the twin's walk counts (the twins walk in the kernels' order)."""
    nbytes = (n_rays * (in_bytes + out_bytes) + NODE_BYTES * counts["distinct_nodes"]
              + ROW_BYTES * counts["distinct_rows"])
    ops = 8 * SLAB_OPS * counts["visits"] + 8 * MT_OPS * counts["rows"]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return dict(counts, bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


@torch.no_grad()
def knear_call(out: dict, view: str, call: str, wide, rays: Rays, k: int, t_max,
               count: bool) -> torch.Tensor:
    """knear8 against its twin on every ray of `rays`: the twin in
    PARITY_CHUNK chunks, timed as plain_ms, the kernel's ms by CUDA events,
    and with `count` the bound from the twin's walk counts; stored in
    out[key][call].  Fails on more than MAX_MISMATCH_FRAC of rays with
    differing id lists.  Returns the twin's ids."""
    n_r = rays.o.shape[0]
    tm = torch.as_tensor(t_max, dtype=torch.float32, device=rays.o.device)
    tm = tm.expand(n_r).contiguous()

    def twin(lo: int, hi: int, stats=None):
        return (k8.k_nearest_wide8_ref(rays_slice(rays, slice(lo, hi)), wide, k, BAND,
                                       t_max=tm[lo:hi], stats=stats),)

    got = k8.k_nearest_wide8(rays, wide, k, BAND, t_max=tm)
    (ref,), plain = chunked(twin, n_r)
    bad = int((got != ref).any(dim=1).sum())
    ms = cuda_ms(lambda: k8.k_nearest_wide8(rays, wide, k, BAND, t_max=tm), iters=5)
    out["ms"][call], out["plain_ms"][call] = ms, plain
    out["mismatch_frac"][call] = bad / n_r
    extra = {}
    if count:
        extra = out["bound"][call] = bound(counted(twin, n_r), n_r, 28, 4 * k)
    phase("knear_parity", view=view, call=call, k=k, rays=n_r,
          id_list_mismatches=bad, filled_frac=f"{float((ref >= 0).float().mean()):.4f}",
          knear8_ms=f"{ms:.4f}", knear8_plain_ms=f"{plain:.1f}", **extra)
    if bad > MAX_MISMATCH_FRAC * n_r:
        fail(f"knear8 ({view}, {call}): {bad} id lists differ from the twin's")
    return ref


def occluder_call(table, scene, rays: Rays, ids: torch.Tensor):
    """The soft render's second knear8 call from a chunk's layer ids: the
    shadow-candidate rays from layer 0's points and the pipeline's
    2 x segment t_max."""
    _, _, cand, t_seg = occluder_rays(soft_surface(table, rays, ids), scene.lights.pos)
    return cand, (2.0 * t_seg).contiguous()


def knear_parity(view: str, tracer: Tracer, frame: Rays, count: bool = False) -> dict:
    """knear8 against its twin on every ray of the frame, in both of the
    soft render's calls: k = 4 on the primary rays with t_max = T_MAX, and
    k = 8 on the shadow-candidate rays from layer 0's points."""
    out = {"ms": {}, "plain_ms": {}, "mismatch_frac": {}, "bound": {}}
    with torch.no_grad():
        ids = knear_call(out, view, "layers", tracer.wide, frame, SOFT["k_layers"], T_MAX,
                         count)
        cand, tm = occluder_call(tracer.table, tracer.scene, frame, ids)
        knear_call(out, view, "occluders", tracer.wide, cand, SOFT["k_occ"], tm, count)
    return out


@torch.no_grad()
def fit_knear(inv: InverseRenderer, scene, cam: Camera) -> dict:
    """knear8 as InverseRenderer.fit calls it: on the step's refit tree and
    the fit's row-major ray chunks.  Both calls on chunk 0 against the twin,
    with their bounds ([knear_parity] view=fit_chunk0), and the kernel's ms
    of each call summed over the frame's FIT_CHUNKS chunks (CUDA events);
    the refit's ms."""
    table = tri_table(scene.tris)
    refit_ms = cuda_ms(lambda: refit_wide_direct(inv.tracer0.wide, scene.tris, table=table),
                       iters=5)
    wide = refit_wide_direct(inv.tracer0.wide, scene.tris, table=table)
    rays = gen_primary_rays(cam)
    m = rays.o.shape[0] // FIT_CHUNKS
    out = {"ms": {}, "plain_ms": {}, "mismatch_frac": {}, "bound": {},
           "frame_ms": {"layers": 0.0, "occluders": 0.0}}
    chunk = rays_slice(rays, slice(0, m))
    ids = knear_call(out, "fit_chunk0", "layers", wide, chunk, SOFT["k_layers"], T_MAX, True)
    cand, tm = occluder_call(table, scene, chunk, ids)
    knear_call(out, "fit_chunk0", "occluders", wide, cand, SOFT["k_occ"], tm, True)
    for c in range(FIT_CHUNKS):
        chunk = rays_slice(rays, slice(c * m, (c + 1) * m))
        ids = k8.k_nearest_wide8(chunk, wide, SOFT["k_layers"], BAND)
        cand, tm = occluder_call(table, scene, chunk, ids)
        out["frame_ms"]["layers"] += cuda_ms(
            lambda: k8.k_nearest_wide8(chunk, wide, SOFT["k_layers"], BAND), iters=5)
        out["frame_ms"]["occluders"] += cuda_ms(
            lambda: k8.k_nearest_wide8(cand, wide, SOFT["k_occ"], BAND, t_max=tm), iters=5)
    phase("fit_pieces", refit_ms=f"{refit_ms:.4f}", chunk_rays=m,
          knear8_layers_ms=f"{out['ms']['layers']:.4f}",
          knear8_occluders_ms=f"{out['ms']['occluders']:.4f}",
          knear8_layers_frame_ms=f"{out['frame_ms']['layers']:.4f}",
          knear8_occluders_frame_ms=f"{out['frame_ms']['occluders']:.4f}")
    return out


def fit_phase(scene, cam: Camera) -> dict:
    """The fit step, through InverseRenderer.fit, with its launch counts."""
    rcfg = RenderConfig(method="wide8", **SOFT)
    inv, s_init = sync_time(lambda: InverseRenderer(
        scene, cam, fit=FitConfig(steps=FIT_STEPS, grad_chunks=FIT_CHUNKS, lr=FIT_LR),
        render=rcfg))
    with torch.no_grad():
        dim = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, albedo=scene.tris.albedo * 0.8))
        target, s_target = sync_time(lambda: render(dim, cam, tracer=inv.tracer0, **SOFT))
    torch.cuda.reset_peak_memory_stats()
    secs, t_last = [], [0.0]

    def on_step(i: int, loss: float) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        secs.append(now - t_last[0])
        t_last[0] = now

    k8.reset_launches()
    torch.cuda.synchronize()
    t_last[0] = time.perf_counter()
    res = inv.fit(target, callback=on_step)
    launches = dict(k8.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n = cam.width * cam.height
    rays_s = n / float(np.mean(secs[1:])) if len(secs) > 1 else n / secs[0]
    ok = (all(np.isfinite(x) for x in res.losses)
          and all(np.isfinite(g[k]) and g[k] > 0 for g in res.grad_norms for k in g)
          and set(res.grad_norms[0]) == {"verts", "albedo"})
    phase("fit", tris=scene.num_tris, rays=n, steps=FIT_STEPS, chunks=FIT_CHUNKS,
          chunk_rays=n // FIT_CHUNKS, init_s=f"{s_init:.3f}", target_s=f"{s_target:.3f}",
          step_s=[round(x, 4) for x in secs], fwd_bwd_rays_per_s=f"{rays_s:.1f}",
          losses=[round(x, 6) for x in res.losses], loss_fell=res.losses[-1] < res.losses[0],
          grad_norms=json.dumps(res.grad_norms), peak_mem_bytes=peak,
          launches=json.dumps(launches), finite_nonzero=ok)
    if not ok:
        fail("a fit loss or gradient is not finite, or a gradient is zero")
    if launches["knear8"] < 2 * FIT_CHUNKS * FIT_STEPS:
        fail(f"the fit launched knear8 {launches['knear8']} times "
             f"(< {2 * FIT_CHUNKS * FIT_STEPS})")
    return dict(inv=inv, target=target, launches=launches)


def generic_cornell(dev, res: int = GATE_RES):
    """Cornell in generic position (tests/grad/test_fdcheck.py's recipe with
    a numpy seed): vertices jittered by up to 0.015, an off-axis light, so
    no face sits exactly on a shading kink."""
    scene, cam = make_cornell_box(device=dev)
    jit = np.random.default_rng(9).uniform(-0.015, 0.015, tuple(scene.tris.verts.shape))
    tris = dataclasses.replace(scene.tris, verts=scene.tris.verts + torch.tensor(
        jit, dtype=torch.float32, device=dev))
    light = PointLight.create((0.43, 0.91, 0.56), (14.0,) * 3, device=dev)
    return (dataclasses.replace(scene, tris=tris, lights=light),
            dataclasses.replace(cam, width=res, height=res))


def gate_loss(scene, cam, method: str):
    """mean(w * image) as a function of (verts, albedo), the wide8 tree
    built once at band GATE['band'] and refit inside, as the fit step does."""
    dev = scene.tris.verts.device
    w = torch.tensor(np.random.default_rng(3).uniform(0.2, 1.0, (cam.height, cam.width, 3)),
                     dtype=torch.float32, device=dev)
    tracer0 = make_tracer(scene, method, band=GATE["band"])

    def loss(params):
        verts, albedo = params
        tris = dataclasses.replace(scene.tris, verts=verts, albedo=albedo)
        tracer = tracer0
        if method == "wide8":
            frozen = dataclasses.replace(tris, verts=verts.detach())
            tracer = dataclasses.replace(tracer0, wide=refit_wide_direct(tracer0.wide, frozen))
        return torch.mean(w * render(dataclasses.replace(scene, tris=tris), cam,
                                     tracer=tracer, **GATE))

    return loss, (scene.tris.verts.clone(), scene.tris.albedo.clone())


def gate_grads(dev):
    loss, params = gate_loss(*generic_cornell(dev), "wide8")
    params = [p.requires_grad_(True) for p in params]
    return [g.detach().cpu() for g in torch.autograd.grad(loss(params), params)]


def fit_check(dev) -> dict:
    """Small soft checks on the card: the wide8 image against brute, the
    wide8 gradients against the CPU, finite differences at tpurt's
    thresholds, and a 5-step albedo fit whose loss must fall."""
    scene, cam = generic_cornell(dev)
    with torch.no_grad():
        img_w = render(scene, cam, method="wide8", **GATE)
        img_b = render(scene, cam, method="brute", **GATE)
    ok_frac = float(((img_w - img_b).abs().amax(dim=-1) <= IMAGE_ATOL).float().mean())
    g_dev, g_cpu = gate_grads(dev), gate_grads(torch.device("cpu"))
    grad_err = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_dev, g_cpu)]
    loss, params = gate_loss(*generic_cornell(dev, FD_RES), "wide8")
    fd = check_grads_fd(loss, params, eps=1e-3, rtol=6e-2, atol=2e-3,
                        max_probes_per_leaf=8, seed=1)
    with torch.no_grad():
        dim = dataclasses.replace(scene, tris=dataclasses.replace(
            scene.tris, albedo=scene.tris.albedo * 0.8))
        target = render(dim, cam, method="brute", **SOFT)
    fit = InverseRenderer(scene, cam, fit=FitConfig(steps=5, lr=1e-2, fit_verts=False,
                                                    grad_chunks=2),
                          render=RenderConfig(method="wide8", **SOFT)).fit(target)
    phase("fit_check", res=GATE_RES, fd_res=FD_RES, image_ok_frac=f"{ok_frac:.5f}",
          grad_rel_err_verts=repr(grad_err[0]), grad_rel_err_albedo=repr(grad_err[1]),
          fd_probes=fd["n_probes"], fd_max_abs_err=f"{fd['max_abs_err']:.3e}",
          fd_max_rel_err=f"{fd['max_rel_err']:.3e}",
          albedo_fit_losses=[round(x, 6) for x in fit.losses])
    if ok_frac < IMAGE_MIN_FRAC:
        fail(f"wide8 soft image: only {ok_frac} of pixels within {IMAGE_ATOL} of brute")
    if max(grad_err) > GRAD_DEVICE_RTOL:
        fail(f"wide8 gradients on the card differ from the CPU's by {grad_err}")
    if not fit.losses[-1] < fit.losses[0]:
        fail(f"the albedo fit's loss did not fall: {fit.losses}")
    return dict(grad_err=grad_err)


def profile_fit(inv: InverseRenderer, target: torch.Tensor) -> None:
    """Where one fit step's device time goes (torch.profiler): knear8's
    kernels, the backward (autograd's evaluate_function ranges; within it
    the index_add_/scatter kernels), the refit (its record_function range)
    and the rest, the forward glue; and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    inv.fit(target, steps=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        inv.fit(target, steps=1)
        torch.cuda.synchronize()
    dev_events, busy, window, total = device_spans(prof)
    if not dev_events:
        phase("profile_fit", device_time="not measured (the profiler saw no device event)")
        return

    def kernel_time(*keys):
        return sum(e.time_range.end - e.time_range.start for e in dev_events
                   if any(k in e.name for k in keys))

    def range_time(pred):
        return sum(getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))
                   for a in prof.key_averages() if pred(a.key))

    knear = kernel_time("knear8_kernel")
    scatter = kernel_time("indexFunc", "scatter")
    backward = range_time(lambda k: k.startswith("autograd::engine::evaluate_function"))
    refit = range_time(lambda k: k == "tpurt::refit")
    glue = total - knear - backward - refit
    phase("profile_fit", device_window_ms=f"{window / 1e3:.3f}",
          device_busy_ms=f"{busy / 1e3:.3f}", idle_share=f"{1 - busy / window:.4f}",
          knear8_share=f"{knear / total:.4f}", backward_share=f"{backward / total:.4f}",
          index_add_scatter_share=f"{scatter / total:.4f}",
          backward_rest_share=f"{(backward - scatter) / total:.4f}",
          refit_share=f"{refit / total:.4f}", forward_glue_share=f"{glue / total:.4f}",
          device_kernels=len(dev_events))



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
    t_start = time.perf_counter()

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
    main_par = parity("main", tracer, frame, count=True)
    over_par = parity("overview", tracer, overview)
    subset_timing(wide, frame, main_par)

    # -- the soft path's tree and knear8 against its twin ------------------
    soft_tracer, s_band = sync_time(lambda: make_tracer(scene, "wide8", band=BAND))
    phase("scene_band", band=BAND, wides=soft_tracer.wide.num_wides,
          tri_rows=soft_tracer.wide.num_rows, max_stack=soft_tracer.wide.max_stack,
          build_s=f"{s_band:.3f}")
    kn_main = knear_parity("main", soft_tracer, frame, count=True)
    kn_over = knear_parity("overview", soft_tracer, overview)
    del soft_tracer

    # -- the main path, hard: render() through closest8 and occluded8 ------
    k8.reset_launches()
    img, s_render = sync_time(lambda: render(scene, cam, method="wide8",
                                             tracer=tracer))
    launches = dict(k8.LAUNCHES)
    hit_frac = float(k8.traverse_wide8(frame, wide).valid.float().mean())
    finite = bool(torch.isfinite(img).all())
    phase("render", shape=tuple(img.shape), seconds=f"{s_render:.3f}",
          finite=finite, hit_frac=f"{hit_frac:.4f}",
          launches=json.dumps(launches), mean=f"{float(img.mean()):.5f}")
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not finite:
        fail("the rendered image is not a finite (H, W, 3) array")
    if not 0.5 < hit_frac <= 1.0:
        fail(f"hit fraction {hit_frac} outside (0.5, 1.0]")
    for name in ("closest8", "occluded8"):
        if launches[name] <= 0:
            fail(f"the hard render never launched {name}")

    # -- reference images (tpurt's goldens) on the card -------------------
    sc, cm = make_cornell_box(device=dev)
    bad_c = golden_check(render(sc, dataclasses.replace(cm, width=64, height=64),
                                method="wide8"), "cornell_brute_64.npy", 0.003)
    sb, cb = make_bunny_scene(num_tris=3000, device=dev)
    bad_b = golden_check(render(sb, dataclasses.replace(cb, width=48, height=48),
                                method="wide8"), "bunny3k_packet_48.npy", 0.003)
    bad_s = golden_check(render(sc, dataclasses.replace(cm, width=48, height=48),
                                method="wide8", **SOFT), "cornell_soft_48.npy", 0.003)
    phase("golden", cornell_wide8_bad=bad_c, bunny3k_wide8_bad=bad_b,
          cornell_soft_wide8_bad=bad_s)

    # -- full-frame timing and where its device time goes -----------------
    frame_ms = frame_timing(tracer, frame, main_par)
    profile_frame(tracer, cam, frame)
    del tracer, bvh, wide, main_par["sh_rays"], over_par["sh_rays"]

    # -- the main path, fit: InverseRenderer.fit through knear8 ------------
    fit = fit_phase(scene, cam)
    kn_fit = fit_knear(fit["inv"], scene, cam)
    fit_check(dev)
    profile_fit(fit["inv"], fit["target"])

    def entry(name, launches_n, err, ms, plain, b, **extra):
        # library_ms: no single PyTorch call computes a BVH walk
        return {"name": name, "route": "cuda", "source": KERNEL_SRC,
                "replaces": REPLACES[name], "launches": launches_n, "max_abs_err": err,
                "ms": round(ms, 4), "plain_ms": round(plain, 4),
                "bound_ms": round(b["bound_ms"], 6), "bound_by": b["bound_by"],
                "library_ms": None, **extra}

    kernels = [entry(name, launches[name], max(main_par["err"][name], over_par["err"][name]),
                     frame_ms[name], main_par["plain_ms"][name], main_par["bound"][name])
               for name in ("closest8", "occluded8")]
    # knear8: the layers call (k = 4) on the main view's Morton-ordered
    # frame, the occluders call beside it, and both calls as the fit makes
    # them (row-major chunk 0, and summed over the fit's chunks); max_abs_err
    # is the fraction of id lists that differ from the twin's, over every
    # call, view and the fit's chunk
    knear_err = max(v for kn in (kn_main, kn_over, kn_fit) for v in kn["mismatch_frac"].values())
    fit_keys = {}
    for call in ("layers", "occluders"):
        fit_keys.update({
            f"fit_chunk0_ms_{call}": round(kn_fit["ms"][call], 4),
            f"fit_chunk0_plain_ms_{call}": round(kn_fit["plain_ms"][call], 4),
            f"fit_chunk0_bound_ms_{call}": round(kn_fit["bound"][call]["bound_ms"], 6),
            f"fit_frame_ms_{call}": round(kn_fit["frame_ms"][call], 4)})
    kernels.append(entry(
        "knear8", fit["launches"]["knear8"], knear_err, kn_main["ms"]["layers"],
        kn_main["plain_ms"]["layers"], kn_main["bound"]["layers"],
        id_mismatch_frac=knear_err, occluders_ms=round(kn_main["ms"]["occluders"], 4),
        occluders_plain_ms=round(kn_main["plain_ms"]["occluders"], 4),
        occluders_bound_ms=round(kn_main["bound"]["occluders"]["bound_ms"], 6), **fit_keys))
    phase("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
