"""Metrics registry (counterpart of ``mxnet_tpu/telemetry``)."""
from .registry import REGISTRY, Counter, Gauge, Histogram

__all__ = ["REGISTRY", "Counter", "Gauge", "Histogram"]
