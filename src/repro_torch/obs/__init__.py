"""Runtime observability of the training step: phase spans, the per-step
metrics stream, the rank heartbeat.

Port of ``repro.obs`` (``spans``, ``metrics``, ``heartbeat``, ``phased``).
``spans``, ``metrics`` and ``heartbeat`` import nothing but the standard
library at import time; ``phased`` builds on the engine and is imported by
its one consumer (``train.trainer``), never here.
"""
from . import heartbeat, metrics, spans
from .spans import SpanRecorder, TraceConfig, scope, tracing

__all__ = [
    "spans", "metrics", "heartbeat",
    "SpanRecorder", "TraceConfig", "scope", "tracing",
]
