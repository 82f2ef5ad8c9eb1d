"""Structured metric lines (counterpart of ``tpurt/obs/meter.py``).

``emit`` prints one JSON metric line.  Time a device region only after
``torch.cuda.synchronize()``: PyTorch returns before the card finishes.
"""

from __future__ import annotations

import json
import sys


def emit(metric: str, value: float, unit: str, stream=None, **extra) -> dict:
    """Print one structured JSON metric line."""
    row = {"metric": metric, "value": value, "unit": unit, **extra}
    print(json.dumps(row), file=stream or sys.stdout, flush=True)
    return row
