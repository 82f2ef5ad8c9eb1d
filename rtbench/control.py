"""The check's control: the plain reference put in the port's place and
computed in bfloat16, the precision below the float32 the configuration
states.  It has to come out as not correct.  The benchmark's runs never
run it; run it at a cell's own size on the card:

    python3 rtbench/control.py --workload sponza1m.frames --seeds 1 2 3

With --fault NAME it plants one of ``faults.py``'s faults in the port
instead and runs the cell (a --seconds window), printing the compared
numbers: how each fault reads at the cell's own size.

For each seed, one JSON line: for a frames cell, it samples the pixels a
run would check (the run's pixel table, over a path of --frames frames),
renders them by the reference in float32 and in bfloat16, and prints the
compared number of the bfloat16 render beside the cell's limit; for the
fit, it follows the check's steps in both precisions and prints the
compared numbers of the bfloat16 fit beside the limits.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def reading(root: str, workload: str, seed: int, device, frames: int = 2048) -> dict:
    import numpy as np
    import torch

    from rtbench import harness
    from rtbench.drivers import common
    from rtbench.drivers.frames import Path, reference_pixels
    from rtbench.frozen import views
    from rtbench.reference import hard

    cell = harness.find_cell(root, workload)
    mix = cell.traffic
    check = mix["check"]
    arrays = common.scene_arrays(cell.config, mix)
    path = Path(cell.config, mix, seed, device)
    n_check = min(frames, int(check["pixels"]) // path.pix.shape[1])
    chosen = np.sort(views.run_rng(seed, 4).choice(frames, n_check, replace=False))
    ref = hard.RefScene.from_arrays(arrays, device)
    sampler = hard.EmitterSampler(arrays, device) if path.samples else None
    want = reference_pixels(ref, sampler, path, chosen, path.frame_pixels)
    low = reference_pixels(ref.cast(torch.bfloat16), sampler, path, chosen, path.frame_pixels)
    return {"workload": workload, "seed": seed, "control": "bfloat16 reference",
            "px_off_frac": hard.off_frac(low, want, check["atol"], check["rtol"]),
            "limit": check["px_off_frac"]}


def fit_reading(cell, seed: int, device) -> dict:
    """The fit's compared numbers of the reference followed in bfloat16
    against the same in float32, over the check's steps."""
    import torch

    from rtbench.drivers import common, fit
    from rtbench.frozen import camera
    from rtbench.reference import soft

    mix, cfg = cell.traffic, cell.config
    arrays = common.scene_arrays(cfg, mix)
    view = camera.View.create(mix["eye"], mix["target"], mix["fov_deg"], cfg["width"],
                              cfg["height"], device)
    o, d = camera.primary_rays(view)
    target = fit.target_image(cell, arrays, o, d, device)
    begin = fit.start_arrays(arrays, mix["start"], seed)
    start = {"verts": torch.as_tensor(begin.verts, device=device),
             "albedo": torch.as_tensor(begin.albedo, device=device)}
    faces = torch.as_tensor(arrays.faces, device=device)
    emission = torch.as_tensor(arrays.emission, device=device)
    scene = {k: torch.as_tensor(getattr(arrays, k), device=device)
             for k in ("light_pos", "light_intensity", "background", "ambient")}
    args = (start, faces, emission, scene, o, d, target, mix["soft"], int(mix["check"]["steps"]),
            mix["fit"]["grad_chunks"], mix["fit"]["lr"])
    want = soft.follow(*args)
    low = soft.follow(*args, dtype=torch.bfloat16)
    return {"workload": cell.name, "seed": seed, "control": "bfloat16 reference",
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(low["losses"], want["losses"])),
            "grad1_gap": fit._gap(low["grad1"], want["grad1"]),
            "change_gap": fit._gap(low["change"], want["change"]),
            "limits": mix["check"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=2048)
    ap.add_argument("--fault", default=None,
                    help="instead of the control, plant this fault (faults.py) in the port and "
                         "run the cell's --seconds window")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("rtbench control: needs a CUDA card", file=sys.stderr)
        return 2
    from rtbench import harness
    cell = harness.find_cell(ROOT, args.workload)
    for seed in args.seeds:
        if args.fault:
            import time

            from rtbench import faults
            with faults.planted(cell.traffic["driver"], args.fault):
                result, _ = harness.run(ROOT, args.workload, seed, args.seconds, False, "cuda",
                                        time.perf_counter())
            out = {"workload": args.workload, "seed": seed, "fault": args.fault,
                   "correct": result["correct"], "checks": result["checks"]}
        elif cell.traffic["driver"] == "fit":
            out = fit_reading(cell, seed, "cuda")
        else:
            out = reading(ROOT, args.workload, seed, "cuda", args.frames)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
