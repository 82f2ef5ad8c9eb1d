"""The fit driver: ``InverseRenderer.fit`` driven the way users run it, its
own loop with one ``float(loss)`` and the gradient norms a step.

The mix's file gives the camera (``eye``, ``target``, ``fov_deg``), the
start (``start``: the vertices scaled about the origin, each triangle's
albedo times a factor drawn from --seed), the fit's settings (``fit``),
the soft render's (``soft``) and the check (``check``).  The target is
the reference's hard render of the true scene, kept in a fixed file under
``rtbench/_cache`` once the first run has made it.

One fit call serves set-up, check and window: its first ``check.steps``
steps are set-up (they build the tree, load the kernels and warm every
shape) and the ones the reference follows; each later step is timed
through the fit's callback, and the callback ends the fit once the
window's seconds are spent (the step that crosses them is the window's
last).  With --trace 1 the callback then profiles two more steps.
"""

from __future__ import annotations

import hashlib
import json
import os
from types import SimpleNamespace

import numpy as np
import torch

from rtbench.drivers import common
from rtbench.frozen import camera, scene as frozen_scene, views, window
from rtbench.harness import Measured
from rtbench.reference import hard, soft

TRACE_STEPS = 2


class _Stop(Exception):
    """Raised from the fit's callback to end the fit."""


def start_arrays(arrays: frozen_scene.SceneArrays, start: dict, seed: int):
    """The fit's start: vertices scaled, albedo times seeded factors."""
    factor = views.run_rng(seed, 6).uniform(*start["albedo_factor"], (arrays.num_tris, 1))
    return frozen_scene.SceneArrays(**{
        **arrays.__dict__,
        "verts": (arrays.verts * np.float32(start["vert_scale"])).astype(np.float32),
        "albedo": (arrays.albedo * factor.astype(np.float32)).astype(np.float32)})


def target_image(cell, arrays, o, d, device) -> torch.Tensor:
    """The reference's hard render of the true scene (R, 3), from its file
    under rtbench/_cache when an earlier run made it."""
    key = hashlib.sha256(json.dumps([cell.config, cell.traffic["eye"], cell.traffic["target"],
                                     cell.traffic["fov_deg"]], sort_keys=True).encode())
    path = os.path.join(cell.root, "rtbench", "_cache", f"target-{key.hexdigest()[:16]}.pt")
    if os.path.exists(path):
        return torch.load(path, map_location=device)
    ref = hard.RefScene.from_arrays(arrays, device)
    img = torch.cat([hard.shade(ref, o[s:s + 262_144], d[s:s + 262_144])
                     for s in range(0, o.shape[0], 262_144)])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(img.cpu(), path + ".tmp")
    os.replace(path + ".tmp", path)
    del ref
    common.free(device)
    return img


def _gap(got: dict, want: dict) -> float:
    """The worst leaf's |norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median(list(want.values())))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in want)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float):
    from tpurt_torch.api.config import FitConfig, RenderConfig
    from tpurt_torch.api.inverse import InverseRenderer
    from tpurt_torch.core.geometry import Camera

    config, mix = cell.config, cell.traffic
    arrays = common.scene_arrays(cell)
    view = camera.View.create(mix["eye"], mix["target"], mix["fov_deg"], config["width"],
                              config["height"], device)
    o, d = camera.primary_rays(view)
    target = target_image(cell, arrays, o, d, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    begin = start_arrays(arrays, mix["start"], seed)
    scene = common.port_scene(begin, device)
    cam = Camera.create(eye=mix["eye"], target=mix["target"], fov_y_deg=mix["fov_deg"],
                        width=config["width"], height=config["height"], device=device)
    f = mix["fit"]
    fit_cfg = FitConfig(steps=1 << 30, lr=f["lr"], optimizer=f["optimizer"],
                        grad_chunks=f["grad_chunks"], rebuild_every=f["rebuild_every"],
                        rebuild_ratio=f["rebuild_ratio"], ckpt_path=None)
    s = mix["soft"]
    render_cfg = RenderConfig(method=config["engine"], soft=True, k_layers=s["k_layers"],
                              sharpness=s["sharpness"], band=s["band"], k_occ=s["k_occ"])

    class Observed(InverseRenderer):
        """The port's InverseRenderer, its parameters and optimizer kept
        in sight for the check (the step itself is the port's)."""

        def _step(self, params, opt, o_, d_, target_):
            self.live = (params, opt)
            return super()._step(params, opt, o_, d_, target_)

    inv = Observed(scene, cam, fit=fit_cfg, render=render_cfg)
    start = {k: v.detach().clone() for k, v in inv.init_params().items()}
    n_follow = int(mix["check"]["steps"])
    st = {"losses": [], "curve": [], "times": [], "trace": None, "stretch": None, "tries": 0}

    def callback(i: int, loss: float) -> None:
        now = common.now()
        params, opt = inv.live
        st["curve"].append(loss)
        if i < n_follow:
            st["losses"].append(loss)
            if i == 0:
                b1 = opt.defaults["betas"][0]
                st["grad1"] = {k: float((opt.state[p]["exp_avg"].double() / (1 - b1)).norm())
                               for k, p in params.items()}
            if i == n_follow - 1:
                st["change"] = {k: float((p.detach().double() - start[k].double()).norm())
                                for k, p in params.items()}
                common.sync(device)
                st["setup_s"] = common.now() - t_start
                st["t0"] = common.now()
            return
        if "t_end" not in st:
            st["times"].append(now)
            if now - st["t0"] < seconds:
                return
            st["t_end"], st["steps"] = now, i - (n_follow - 1)
            st["peak"] = common.peak_bytes(device)
            if not (trace and torch.device(device).type == "cuda"):
                raise _Stop
            st["stretch"], st["first"] = window.Stretch(window.PAD_WAITS[0]), i
            st["stretch"].start()
            return
        if i - st["first"] < TRACE_STEPS:
            return
        got = st["stretch"].stop()
        st["tries"] += 1
        if got is not None or st["tries"] == len(window.PAD_WAITS):
            st["trace"] = got
            raise _Stop
        st["stretch"], st["first"] = window.Stretch(window.PAD_WAITS[st["tries"]]), i
        st["stretch"].start()

    try:
        inv.fit(target, callback=callback)
    except _Stop:
        pass
    peak = st["peak"]
    rebuilds = inv.rebuilds
    del inv, scene
    common.free(device)

    faces = torch.as_tensor(arrays.faces, device=device)
    emission = torch.as_tensor(arrays.emission, device=device)
    ref_scene = {k: torch.as_tensor(getattr(arrays, k), device=device)
                 for k in ("light_pos", "light_intensity", "background", "ambient")}
    want = soft.follow(start, faces, emission, ref_scene, o, d, target, s, n_follow,
                       f["grad_chunks"], f["lr"])
    check = mix["check"]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(st["losses"], want["losses"]))
    checks = {"loss_gap": {"value": loss_gap, "limit": check["loss_gap"]},
              "grad1_gap": {"value": _gap(st["grad1"], want["grad1"]),
                            "limit": check["grad1_gap"]},
              "change_gap": {"value": _gap(st["change"], want["change"]),
                             "limit": check["change_gap"]}}
    tr = st["trace"]
    ctx = SimpleNamespace(kind="fit", trace=tr, steps_traced=TRACE_STEPS)
    notes = {"device": common.device_line(device, peak, tr),
             "losses": st["losses"], "reference_losses": want["losses"],
             "grad1": st["grad1"], "reference_grad1": want["grad1"],
             "change": st["change"], "reference_change": want["change"], "rebuilds": rebuilds,
             "loss_curve": st["curve"],
             "step_ms": list(np.diff([st["t0"]] + st["times"]) * 1e3)}
    if tr is not None:
        notes["breakdown"] = {"device_ops": window.top_kernels(tr),
                              "idle_gaps": window.idle_gaps(tr)}
    e2e = {"fit_step_ms": (st["t_end"] - st["t0"]) / st["steps"] * 1e3,
           "peak_mem_gib": peak / common.GIB, "setup_s": st["setup_s"]}
    return Measured(end_to_end=e2e, checks=checks, attempted=st["steps"], failed=0, ctx=ctx,
                    notes=notes)
