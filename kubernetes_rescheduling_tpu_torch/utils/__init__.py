"""Host-side utilities of the control loop: structured logging, the
boundary's retry policy, timers and decision-latency histograms, and
checkpoint/resume in the JAX package's format.

The checkpoint names resolve lazily (PEP 562), as in the JAX package:
``utils`` itself imports no tensor state for consumers that only want
``logging`` or ``retry``.
"""

from kubernetes_rescheduling_tpu_torch.utils.logging import StructuredLogger, get_logger
from kubernetes_rescheduling_tpu_torch.utils.profiling import LatencyHistogram, Timer, trace_to
from kubernetes_rescheduling_tpu_torch.utils.retry import (
    RetryPolicy,
    call_with_retry,
    is_transient,
)

_LAZY = {
    "load_state": "checkpoint",
    "save_state": "checkpoint",
    "CheckpointManager": "checkpoint",
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"kubernetes_rescheduling_tpu_torch.utils.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "StructuredLogger",
    "get_logger",
    "RetryPolicy",
    "call_with_retry",
    "is_transient",
    "LatencyHistogram",
    "Timer",
    "trace_to",
    "load_state",
    "save_state",
    "CheckpointManager",
]
