"""Camera paths through the courtyard, and the seeded choices a mix makes.

A traffic file names its views by kind and count, with the seed that
places them (``view_seed``): every run of the mix renders the same views in the same
cyclic order, and the run's ``--seed`` only sets the view the cycle
starts at (so two seeds do the same work), which pixels the check
samples, and the mix's per-frame draws.

- ``walk``: an eye at ``height`` in the disc of ``radius`` around the
  courtyard's centre, looking along a seeded azimuth, pitched down by a
  seeded angle in ``pitch_deg``.
- ``orbit``: an eye on the circle of ``radius`` at ``height``, at a
  seeded azimuth, looking at ``target``.
"""

from __future__ import annotations

import numpy as np

MASK63 = (1 << 63) - 1


def make_views(spec: list[dict], view_seed: int) -> list[tuple[tuple, tuple]]:
    """[(eye, target)] in spec order, drawn from one numpy generator."""
    rng = np.random.default_rng(view_seed)
    views = []
    for group in spec:
        for _ in range(int(group["count"])):
            if group["kind"] == "walk":
                r = group["radius"] * np.sqrt(rng.uniform())
                phi = rng.uniform(0.0, 2.0 * np.pi)
                az = rng.uniform(0.0, 2.0 * np.pi)
                pitch = np.deg2rad(rng.uniform(*group["pitch_deg"]))
                eye = (r * np.cos(phi), group["height"], r * np.sin(phi))
                look = (np.cos(pitch) * np.cos(az), -np.sin(pitch), np.cos(pitch) * np.sin(az))
                target = tuple(e + l for e, l in zip(eye, look))
            elif group["kind"] == "orbit":
                az = rng.uniform(0.0, 2.0 * np.pi)
                eye = (group["radius"] * np.cos(az), group["height"],
                       group["radius"] * np.sin(az))
                target = tuple(group["target"])
            else:
                raise ValueError(f"unknown view kind {group['kind']!r}")
            views.append((tuple(float(x) for x in eye), tuple(float(x) for x in target)))
    return views


def run_rng(seed: int, stream: int) -> np.random.Generator:
    """The run's numpy generator for one purpose (`stream`), from --seed;
    any whole number, negative or past 64 bits, is taken modulo 2^63."""
    return np.random.default_rng([int(seed) & MASK63, stream])


def cycle_order(n_views: int, view_seed: int, seed: int) -> np.ndarray:
    """The order in which the closed loop cycles through the views: one
    fixed order (from the mix's view_seed), entered at a view chosen by
    --seed.  Every seed then renders the same sequence of views, rotated:
    a view's time depends on the one before it (what the card's L2 still
    holds of the tree), so a reordering would change the work."""
    order = np.random.default_rng([int(view_seed), 1]).permutation(n_views)
    return np.roll(order, -int(run_rng(seed, 1).integers(n_views)))


def frame_seeds(seed: int):
    """frame -> the seed of the torch.Generator that frame draws its
    emitter samples from (seeded anew before each frame, so that the
    reference can draw the same samples again)."""
    base = int(run_rng(seed, 2).integers(0, 1 << 62))
    return lambda frame: (base + 0x9E3779B97F4A7C15 * (int(frame) + 1)) % (1 << 62)
