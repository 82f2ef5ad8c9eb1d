"""Observability: tracing spans, structured logs and metric lines
(counterpart of ``tpurt/obs``)."""

from tpurt_torch.obs.log import get_logger
from tpurt_torch.obs.meter import emit
from tpurt_torch.obs.trace import profile_to, trace_span

__all__ = [
    "get_logger",
    "emit",
    "trace_span",
    "profile_to",
]
