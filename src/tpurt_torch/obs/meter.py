"""Throughput meters and structured metric lines (counterpart of
``tpurt/obs/meter.py``).

``Meter`` accumulates (count, seconds) pairs and reports rates; ``emit``
prints one JSON metric line.  Time a device region only after
``torch.cuda.synchronize()``: PyTorch returns before the card finishes.
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field


@dataclass
class Meter:
    """Accumulating rate meter: `tick(n)` per timed region, `rate` = n/s."""

    name: str = "rays"
    count: float = 0.0
    seconds: float = 0.0
    _t0: float | None = field(default=None, repr=False)

    def start(self) -> "Meter":
        self._t0 = time.perf_counter()
        return self

    def stop(self, n: float) -> float:
        """End the region started by `start`, crediting n items; returns the
        region's rate."""
        if self._t0 is None:
            raise RuntimeError("Meter.stop() called without a prior start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.count += n
        self.seconds += dt
        return n / dt if dt > 0 else float("inf")

    def tick(self, n: float, seconds: float) -> None:
        self.count += n
        self.seconds += seconds

    @property
    def rate(self) -> float:
        return self.count / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> dict:
        return {"name": self.name, "count": self.count, "seconds": self.seconds,
                "rate": self.rate}


def emit(metric: str, value: float, unit: str, stream=None, **extra) -> dict:
    """Print one structured JSON metric line."""
    row = {"metric": metric, "value": value, "unit": unit, **extra}
    print(json.dumps(row), file=stream or sys.stdout, flush=True)
    return row
