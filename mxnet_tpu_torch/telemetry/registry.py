"""Process-wide metric registry: the subset the decode engine and the
checkpoint writer touch.

Counterpart of ``mxnet_tpu/telemetry/registry.py``: named counters,
gauges and histograms created once at import and updated on the hot
path.  Exporters, labels, retrace sites and the vital-witness machinery
of the JAX package come with the operations slice.
"""
from __future__ import annotations

import bisect
import threading

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY"]

_DEFAULT_BOUNDS = (0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000,
                   5000, 10000)


class _Metric:
    kind = None

    def __init__(self, name, help="", unit=None):
        self.name = name
        self.help = help
        self.unit = unit
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotone count."""
    kind = "counter"

    def __init__(self, name, help="", unit=None):
        super().__init__(name, help, unit)
        self.value = 0

    def inc(self, n=1):
        with self._lock:
            self.value += n


class Gauge(_Metric):
    """Last-set value."""
    kind = "gauge"

    def __init__(self, name, help="", unit=None):
        super().__init__(name, help, unit)
        self.value = 0

    def set(self, v):
        self.value = v


class Histogram(_Metric):
    """Bucketed observations (upper bounds ``bounds``, plus +Inf)."""
    kind = "histogram"

    def __init__(self, name, help="", unit=None, bounds=_DEFAULT_BOUNDS):
        super().__init__(name, help, unit)
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0

    def observe(self, v):
        with self._lock:
            self.buckets[bisect.bisect_left(self.bounds, v)] += 1
            self.count += 1
            self.sum += v


class Registry:
    """Name -> metric; re-registering a name returns the existing
    metric of the same kind."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, *args, **kwargs)
            elif not isinstance(m, cls):
                raise ValueError("metric %r already registered as a %s"
                                 % (name, m.kind))
            return m

    def counter(self, name, help="", unit=None):
        return self._get_or_make(Counter, name, help, unit)

    def gauge(self, name, help="", unit=None):
        return self._get_or_make(Gauge, name, help, unit)

    def histogram(self, name, help="", unit=None, bounds=_DEFAULT_BOUNDS):
        return self._get_or_make(Histogram, name, help, unit, bounds)


REGISTRY = Registry()
