"""Preemption handling: SIGTERM -> emergency save and a clean stop.

Counterpart of ``mxnet_tpu/checkpoint/preemption.py``.  A preempted
machine gets SIGTERM with a short grace window before SIGKILL.
``PreemptionHandler`` turns the first signal into a sticky flag that
the fit loop polls at each step boundary (``CheckpointManager.tick``):
the loop then takes one synchronous emergency checkpoint, drains the
async writer and returns from ``fit`` instead of dying mid-write.
Python runs signal handlers on the main thread between bytecodes, so a
training loop on the main thread sees the flag within one step.

The handler chains to any previously installed callable handler and
restores the original disposition on :meth:`uninstall` (driven by
``CheckpointManager.close``).
"""
from __future__ import annotations

import logging
import signal
import threading

__all__ = ["PreemptionHandler"]


class PreemptionHandler:
    """Sticky signal flag with install/uninstall and chaining."""

    def __init__(self, signals=(signal.SIGTERM,), logger=None):
        self.signals = tuple(signals)
        self.logger = logger or logging
        self._event = threading.Event()
        self._previous = {}
        self._installed = False
        self._lock = threading.Lock()

    @property
    def triggered(self):
        return self._event.is_set()

    def trigger(self):
        """Mark preemption requested (also callable directly, e.g. from
        a cloud metadata watcher thread)."""
        self._event.set()

    def clear(self):
        self._event.clear()

    def _handle(self, signum, frame):
        # NO logging here: a signal handler re-entering the logging
        # module's lock (held by the interrupted main thread) would
        # self-deadlock the very path that must save state. The flag is
        # acted on — and logged — at the next step boundary
        # (CheckpointManager.emergency_save).
        self._event.set()
        prev = self._previous.get(signum)
        if callable(prev):
            prev(signum, frame)

    def install(self):
        """Install on the configured signals. Safe to call from a
        non-main thread: installation is skipped with a warning
        (``signal.signal`` only works on the main thread) and the
        handler can still be driven via :meth:`trigger`."""
        with self._lock:
            if self._installed:
                return self
            try:
                for sig in self.signals:
                    self._previous[sig] = signal.signal(sig, self._handle)
            except ValueError:
                # roll back any handlers already swapped in — a partial
                # install must not leave an unrecoverable disposition
                for sig, prev in self._previous.items():
                    try:
                        signal.signal(sig, prev if prev is not None
                                      else signal.SIG_DFL)
                    except (ValueError, TypeError):
                        pass
                self._previous.clear()
                self.logger.warning(
                    "checkpoint: cannot install signal handlers off the "
                    "main thread; preemption flag remains manual")
                return self
            self._installed = True
        return self

    def uninstall(self):
        """Restore the original handlers (only those still ours)."""
        with self._lock:
            if not self._installed:
                return
            for sig, prev in self._previous.items():
                try:
                    if signal.getsignal(sig) == self._handle:
                        signal.signal(sig, prev if prev is not None
                                      else signal.SIG_DFL)
                except (ValueError, TypeError):
                    pass
            self._previous.clear()
            self._installed = False
