"""Tracing and profiling hooks (counterpart of ``tpurt/obs/trace.py``).

Named spans go into torch.profiler traces (``record_function``) and measure
the host clock; ``profile_to`` writes a Chrome trace of the CPU and, where
there is one, the card.

Usage:
    with trace_span("bvh_build"):
        bvh = build_lbvh(tris)
    with profile_to("traces/"):        # chrome://tracing or perfetto
        renderer.render(cam)
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator

import torch

_log = logging.getLogger("tpurt")


@contextlib.contextmanager
def trace_span(name: str, log: bool = False) -> Iterator[None]:
    """Named span: a torch.profiler range and, with log, a log line of its
    host seconds.  Device work inside is attributed only if the caller
    synchronises (see blocking_span)."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if log:
        _log.info("span %s: %.3f ms", name, 1e3 * (time.perf_counter() - t0))


@contextlib.contextmanager
def blocking_span(name: str, result_holder: dict | None = None) -> Iterator[dict]:
    """Span that records its host seconds into a dict under `name`; callers
    synchronise inside so the device time is attributed to it."""
    out = result_holder if result_holder is not None else {}
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield out
    out[name] = time.perf_counter() - t0


@contextlib.contextmanager
def profile_to(logdir: str) -> Iterator[None]:
    """Profile the block with torch.profiler (CPU, and CUDA when the card
    is there) and write its Chrome trace to ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def compiled_cost(fn, *args) -> dict:
    """Floating-point operations of one call fn(*args), counted by
    torch.utils.flop_counter.FlopCounterMode: {"flops": total}.  It counts
    only the operators PyTorch has FLOP formulas for (matrix products,
    convolutions, attention); elementwise work and the hand-written kernels
    count 0."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": counter.get_total_flops()}
