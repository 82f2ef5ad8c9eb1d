"""A padded profiler window and the arithmetic on its events.

Copied from chip_smoke.py (``device_spans``, ``device_launches``,
``profile_fit``): torch.profiler places device events on the host's clock
with an offset that grows over a process's life and drops those that land
past its window's end, so the window is padded with host waits and marked
by a short spin kernel on each side; the reading is taken only when both
markers are seen, the padding widening over PAD_WAITS.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

import torch

PAD_WAITS = (0.05, 0.3, 1.0)
MARK_CYCLES = 1000
MARKER = "spin_kernel"


@dataclass
class Kernel:
    name: str      # the kernel's name as the profiler prints it, shortened
    start: float   # µs, the profiler's clock
    end: float


@dataclass
class Trace:
    """A traced stretch: its device kernels (markers left out), the host
    ranges (name, start, end, device µs of the kernels launched in them)
    and the union of the kernels' intervals."""

    kernels: list[Kernel]
    ranges: list[tuple[str, float, float, float]] = field(default_factory=list)

    @property
    def total_us(self) -> float:
        return sum(k.end - k.start for k in self.kernels)

    def busy_window_us(self) -> tuple[float, float]:
        """(busy, window): the union of the kernels' intervals, and the
        first kernel's start to the last one's end."""
        spans = sorted((k.start, k.end) for k in self.kernels)
        if not spans:
            return 0.0, 0.0
        busy, end = 0.0, spans[0][0]
        for s, e in spans:
            busy += max(0.0, e - max(s, end))
            end = max(end, e)
        return busy, end - spans[0][0]

    def gaps(self) -> list[tuple[float, float]]:
        """The idle intervals between the kernels, in order."""
        spans = sorted((k.start, k.end) for k in self.kernels)
        out, end = [], None
        for s, e in spans:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def kernel_us(self, pred) -> float:
        return sum(k.end - k.start for k in self.kernels if pred(k.name))


def short_name(name: str) -> str:
    return re.split(r"[(<]", name.replace("(anonymous namespace)::", "")
                    .removeprefix("void "))[0].strip()


def traced(fn) -> Trace | None:
    """Run fn() once under torch.profiler (CPU and CUDA activity) between
    two marker kernels, in a window padded by host waits; None when the
    markers are never both seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for wait in PAD_WAITS:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(wait)
            torch.cuda._sleep(MARK_CYCLES)
            fn()
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
            time.sleep(wait)
        trace = _reading(prof.events(), DeviceType)
        if trace is not None:
            return trace
    return None


def _reading(events, DeviceType) -> Trace | None:
    """The Trace between the two markers, or None unless both are seen."""
    dev = [e for e in events
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    marks = [e for e in dev if MARKER in e.name]
    if len(marks) != 2:
        return None
    lo = min(m.time_range.end for m in marks)
    hi = max(m.time_range.start for m in marks)
    kernels = [Kernel(short_name(e.name), e.time_range.start, e.time_range.end)
               for e in dev if MARKER not in e.name
               and e.time_range.start >= lo and e.time_range.end <= hi]
    ranges = [(e.name, e.time_range.start, e.time_range.end, e.device_time_total)
              for e in events if e.device_type == DeviceType.CPU]
    return Trace(kernels=kernels, ranges=ranges)


def top_kernels(trace: Trace, n: int = 10) -> list[list]:
    """[[name, seconds]] of the n kernels that took most device time."""
    per = {}
    for k in trace.kernels:
        per[k.name] = per.get(k.name, 0.0) + (k.end - k.start)
    return [[name, us / 1e6] for name, us in sorted(per.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(trace: Trace, n: int = 10) -> list[list]:
    """[[host activity, seconds]] of the n longest idle gaps, each named by
    the innermost host range that was running at its middle."""
    out = []
    for s, e in sorted(trace.gaps(), key=lambda g: g[0] - g[1])[:n]:
        mid = 0.5 * (s + e)
        inside = [r for r in trace.ranges if r[1] <= mid <= r[2]]
        name = min(inside, key=lambda r: r[2] - r[1])[0] if inside else "none"
        out.append([name, (e - s) / 1e6])
    return out


class Stretch:
    """A padded profiler window opened and closed from two points of a
    loop the caller does not own (a fit's callback): start() waits, marks
    and returns; stop() marks, waits and returns the Trace, or None when
    the markers were not both seen (the caller may try a longer pad)."""

    def __init__(self, pad: float):
        from torch.profiler import ProfilerActivity, profile
        self.pad = pad
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.__enter__()
        time.sleep(self.pad)
        torch.cuda._sleep(MARK_CYCLES)

    def stop(self) -> Trace | None:
        from torch.autograd import DeviceType
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
        time.sleep(self.pad)
        self.prof.__exit__(None, None, None)
        return _reading(self.prof.events(), DeviceType)
