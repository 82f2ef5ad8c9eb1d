"""What every driver shares: the port's scene from the frozen arrays, the
card's clock and peak, and the device line."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from rtbench.frozen import scene as frozen_scene

GIB = float(1 << 30)


def scene_arrays(config: dict, traffic: dict) -> frozen_scene.SceneArrays:
    """The configuration's courtyard, with the mix's emitters if it has any."""
    arrays = frozen_scene.sponza_arrays(config["num_tris"], config["scene_seed"])
    em = traffic.get("emitters")
    if em:
        arrays = frozen_scene.with_emitters(arrays, em["count"], em["radiance"], em["seed"])
    return arrays


def port_scene(arrays: frozen_scene.SceneArrays, device):
    """The port's Scene built from the frozen arrays through its API."""
    from tpurt_torch.core.geometry import PointLight, Triangles
    from tpurt_torch.core.scene import Scene

    tris = Triangles.create(arrays.verts, arrays.faces, albedo=arrays.albedo,
                            emission=arrays.emission, device=device)
    lights = PointLight.create(arrays.light_pos, arrays.light_intensity, device=device)
    return Scene.create(tris, lights, background=tuple(arrays.background.tolist()),
                        ambient=tuple(arrays.ambient.tolist()))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def power_limit_w() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def device_line(device, peak: int, trace=None) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        line = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": peak}
    else:
        line = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    if trace is not None:
        busy, window = trace.busy_window_us()
        line["busy_s"], line["window_s"] = busy / 1e6, window / 1e6
    return line


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def now() -> float:
    return time.perf_counter()
