"""Observability: tracing spans, throughput meters, structured logs
(counterpart of ``tpurt/obs``)."""

from tpurt_torch.obs.log import get_logger
from tpurt_torch.obs.meter import Meter, emit
from tpurt_torch.obs.trace import blocking_span, compiled_cost, profile_to, trace_span

__all__ = [
    "get_logger",
    "Meter",
    "emit",
    "trace_span",
    "blocking_span",
    "profile_to",
    "compiled_cost",
]
