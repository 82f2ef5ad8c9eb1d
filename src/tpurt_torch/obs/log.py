"""Structured logging with per-process prefixes (counterpart of
``tpurt/obs/log.py``).

Multi-process runs interleave their output; prefixing each record with
``[pN/M]`` keeps them attributable.  Plain std logging.
"""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "tpurt", level: int = logging.INFO) -> logging.Logger:
    """Process-aware logger: records carry a [pN/M] prefix, the rank and
    world size of torch.distributed when it is initialised, else [p0/1]."""
    log = logging.getLogger(name)
    if not log.handlers:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            pid, nproc = dist.get_rank(), dist.get_world_size()
        else:
            pid, nproc = 0, 1
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            f"%(asctime)s [p{pid}/{nproc}] %(name)s %(levelname)s: %(message)s",
            datefmt="%H:%M:%S"))
        log.addHandler(h)
        log.setLevel(level)
        log.propagate = False
    return log
