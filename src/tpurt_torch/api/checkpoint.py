"""Checkpoint and resume for the fit loop (counterpart of
``tpurt/api/checkpoint.py``).

A checkpoint is ``{path}/ckpt_{step:08d}.pt``: the fit's parameter tensors
and its ``torch.optim`` state_dict, saved with ``torch.save`` to a temporary
file in the same directory and renamed into place, so a reader sees a whole
file or none and a fit killed mid-write resumes from the previous step.
The format is the port's own: tpurt's optax state does not carry across.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import torch

_NAME = re.compile(r"ckpt_(\d+)\.pt")


def save_ckpt(path: str, state: Any, step: int) -> str:
    """Write state (tensors, dicts, lists of them) to
    ``{path}/ckpt_{step:08d}.pt`` atomically; returns the file name."""
    os.makedirs(path, exist_ok=True)
    fname = os.path.join(path, f"ckpt_{step:08d}.pt")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save({"step": step, "state": state}, f)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return fname


def latest_step(path: str) -> int | None:
    """Highest checkpointed step in `path`, or None."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path) if (m := _NAME.fullmatch(f))]
    return max(steps) if steps else None


def restore_ckpt(path: str, step: int | None = None) -> tuple[Any, int]:
    """The state saved by save_ckpt at `step` (None: the latest), its
    tensors on the devices they were saved from.  Returns (state, step)."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {path}")
    data = torch.load(os.path.join(path, f"ckpt_{step:08d}.pt"),
                      weights_only=True)
    return data["state"], int(data["step"])
