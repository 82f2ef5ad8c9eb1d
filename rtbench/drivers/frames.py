"""The frames driver: a camera path rendered frame after frame through
``Renderer.render_rays``, one client in a closed loop.

The mix's file gives the views (``views``, ``view_seed``, ``fov_deg``),
the area-light setting (``emitters``, ``light_samples``) and the check
(``check``).  Each frame's rays are made on the card by the frozen
generator just before the call, in row-major order as a camera emits
them; the next frame starts once the previous one is complete on the
card.  A frame's time runs from the start of its rays to its completion.
The window closes at the first end of a cycle through the views once
--seconds have passed, so that every run does whole cycles: the same mix
of views whatever the seed's order.

The check: every frame copies a seeded handful of its pixels out of the
port's result (part of the frame's time); once the window has closed and
the port's state is freed, a seeded sample of those pixels is rendered
again by the plain reference (``reference/hard.py``) and compared.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from rtbench.drivers import common
from rtbench.frozen import camera, views, window
from rtbench.harness import Measured
from rtbench.reference import hard

PIX_ROWS = 1024      # rows of the table of pixels a frame copies out
WARM_FRAMES = 2


class Path:
    """The views of a mix, their cycle order and each frame's draws."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.size = (config["height"], config["width"])
        self.views = [camera.View.create(eye, tgt, traffic["fov_deg"], config["width"],
                                         config["height"], device)
                      for eye, tgt in views.make_views(traffic["views"], traffic["view_seed"])]
        self.order = views.cycle_order(len(self.views), traffic["view_seed"], seed)
        self.seed_of = views.frame_seeds(seed)
        self.samples = int(traffic.get("light_samples", 0))
        k = int(traffic["check"]["pixels_per_frame"])
        pix = views.run_rng(seed, 3).integers(0, self.pixels, (PIX_ROWS, k))
        self.pix = torch.as_tensor(pix, device=device)

    @property
    def pixels(self) -> int:
        return self.size[0] * self.size[1]

    def view(self, frame: int) -> camera.View:
        return self.views[self.order[frame % len(self.views)]]

    def frame_pixels(self, frame: int) -> torch.Tensor:
        return self.pix[frame % PIX_ROWS]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    from tpurt_torch.api.config import RenderConfig
    from tpurt_torch.api.renderer import Renderer
    from tpurt_torch.core.geometry import Rays
    from tpurt_torch.render.pipeline import make_tracer

    config, mix = cell.config, cell.traffic
    arrays = common.scene_arrays(cell)
    path = Path(config, mix, seed, device)
    scene = common.port_scene(arrays, device)
    rcfg = RenderConfig(method=config["engine"], light_samples=path.samples)
    renderer = Renderer(scene, rcfg)
    gen = torch.Generator(device=device) if path.samples else None

    def frame(i: int, spans: bool = False):
        """Render frame i; returns (result, dispatch seconds)."""
        o, d = camera.primary_rays(path.view(i))
        if gen is not None:
            gen.manual_seed(path.seed_of(i))
        t0 = common.now()
        if spans:
            with torch.profiler.record_function("rtbench.render_rays"):
                out = renderer.render_rays(Rays(o=o, d=d), generator=gen)
        else:
            out = renderer.render_rays(Rays(o=o, d=d), generator=gen)
        return out, common.now() - t0

    for i in range(WARM_FRAMES):
        frame(-1 - i)[0].index_select(0, path.frame_pixels(0))
    common.sync(device)
    setup_s = common.now() - t_start

    kept, times, dispatch = [], [], []
    t0 = common.now()
    i = 0
    while True:
        f0 = common.now()
        out, disp = frame(i)
        kept.append(out.index_select(0, path.frame_pixels(i)))
        common.sync(device)
        f1 = common.now()
        times.append(f1 - f0)
        dispatch.append(disp)
        i += 1
        if f1 - t0 >= seconds and i % len(path.views) == 0:
            break
    window_s, frames = f1 - t0, i
    del out
    peak = common.peak_bytes(device)

    tr = tree_ms = None
    if trace and torch.device(device).type == "cuda":
        first = frames

        def stretch():
            for j in range(first, first + len(path.views)):
                with torch.profiler.record_function("rtbench.frame"):
                    frame(j, spans=True)
                    with torch.profiler.record_function("rtbench.sync"):
                        common.sync(device)

        tr = window.traced(stretch)
        common.sync(device)
        t1 = common.now()
        make_tracer(scene, **rcfg.tracer_kwargs())
        common.sync(device)
        tree_ms = (common.now() - t1) * 1e3
    del renderer, scene
    common.free(device)

    ref = hard.RefScene.from_arrays(arrays, device)
    sampler = hard.EmitterSampler(arrays, device) if path.samples else None
    check = mix["check"]
    n_check = min(frames, int(check["pixels"]) // path.pix.shape[1])
    chosen = np.sort(views.run_rng(seed, 4).choice(frames, n_check, replace=False))
    got = torch.cat([kept[f] for f in chosen])
    want = reference_pixels(ref, sampler, path, chosen, lambda f: path.frame_pixels(f))
    checks = {"px_off_frac": {"value": hard.off_frac(got, want, check["atol"], check["rtol"]),
                              "limit": check["px_off_frac"]}}

    work = None
    if tr is not None:
        work = walk_work(ref, sampler, path, range(frames, frames + len(path.views)),
                         int(check["count_pixels"]), seed)
    ctx = SimpleNamespace(kind="frames", trace=tr, frames_traced=len(path.views),
                         dispatch_ms=[x * 1e3 for x in dispatch], tree_build_ms=tree_ms,
                         walk_work=work, power_limit=common.power_limit_w() if tr else None)
    notes = {"device": common.device_line(device, peak, tr)}
    if tr is not None:
        notes["breakdown"] = {"device_ops": window.top_kernels(tr),
                              "idle_gaps": window.idle_gaps(tr)}
    e2e = {"frame_rays_per_s": frames * path.pixels / window_s,
           "frame_ms.p95": common.p95(times) * 1e3,
           "peak_mem_gib": peak / common.GIB,
           "setup_s": setup_s}
    return Measured(end_to_end=e2e, checks=checks, attempted=frames, failed=0, ctx=ctx,
                    notes=notes)


def _rays(path: Path, frames, pixels_of):
    """The rays (and the frame of each) at the given frames' pixels."""
    os_, ds, owner = [], [], []
    for f in frames:
        o, d = camera.primary_rays(path.view(f))
        idx = pixels_of(f)
        os_.append(o[idx])
        ds.append(d[idx])
        owner += [f] * idx.shape[0]
    return torch.cat(os_), torch.cat(ds), owner


def _samples(sampler, path: Path, owner):
    """Each ray's frame's emitter samples, stacked (R, S, ...), or None."""
    if sampler is None:
        return None
    per = {f: sampler.draw(path.seed_of(f), path.samples) for f in sorted(set(owner))}
    return tuple(torch.stack([per[f][j] for f in owner]) for j in range(4))


def reference_pixels(ref, sampler, path: Path, frames, pixels_of, block: int = 8192):
    o, d, owner = _rays(path, frames, pixels_of)
    out = []
    for s in range(0, o.shape[0], block):
        smp = _samples(sampler, path, owner[s:s + block])
        out.append(hard.shade(ref, o[s:s + block], d[s:s + block], smp))
    return torch.cat(out)


def walk_work(ref, sampler, path: Path, frames, per_frame: int, seed: int):
    """(box tests, triangle tests) that the given frames need, each
    frame's counted on a seeded sample of per_frame of its pixels (its
    primary, shadow and area shadow rays) and scaled to the frame."""
    rng = views.run_rng(seed, 5)
    boxes = tris = 0.0
    for f in frames:
        idx = torch.as_tensor(rng.choice(path.pixels, per_frame, replace=False),
                              device=path.pix.device)
        o, d, owner = _rays(path, [f], lambda _: idx)
        _, (b, t) = hard.shade(ref, o, d, _samples(sampler, path, owner), count=True)
        scale = path.pixels / per_frame
        boxes += b * scale
        tris += t * scale
    return boxes, tris
