"""Tracing and profiling hooks (counterpart of ``tpurt/obs/trace.py``).

``trace_span`` is the port's one span primitive: a ``torch.profiler``
range, so it lies on the same clock as the card's kernels in a trace, and
each idle gap of the card can be put down to the span that was open.  With
no profiler running (and no log asked for) it costs one check and enters
nothing.  ``profile_to`` writes a Chrome trace of the CPU and, where there
is one, the card.

Usage:
    with trace_span("bvh_build"):
        bvh = build_lbvh(tris)
    @spanned("tpurt::walk.closest")   # the whole call in one span
    def closest_shaded(self, rays): ...
    with profile_to("traces/"):        # chrome://tracing or perfetto
        renderer.render(cam)
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Callable, ContextManager, Iterator

import torch

_log = logging.getLogger("tpurt")
_OFF = contextlib.nullcontext()


def trace_span(name: str, log: bool = False) -> ContextManager[None]:
    """Named span: a torch.profiler range while a profiler runs and, with
    log, a log line of its host seconds.  Otherwise a shared no-op: no clock
    read, no record_function entered."""
    on = torch.autograd._profiler_enabled()
    if not (log or on):
        return _OFF
    return _span(name, log, on)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """Decorator: each call of the function inside trace_span(name)."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with trace_span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def _span(name: str, log: bool, on: bool) -> Iterator[None]:
    t0 = time.perf_counter()
    with torch.profiler.record_function(name) if on else _OFF:
        yield
    if log:
        _log.info("span %s: %.3f ms", name, 1e3 * (time.perf_counter() - t0))


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
