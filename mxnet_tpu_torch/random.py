"""Seeded random streams of the port.

Counterpart of ``mxnet_tpu/random.py``.  ``seed(s)`` seeds one explicit
``torch.Generator`` per device (made on first use, each seeded with
``s``) and one numpy ``RandomState`` for draws made on the host (the
data iterators' shuffles).  Nothing in the port reads PyTorch's global
generator.  Until ``seed`` is called, each stream starts from fresh
entropy, as the reference's unseeded streams do.

The streams are not the JAX package's: ``jax.random`` keys and torch
generators give different numbers from the same seed, so a test that
needs the same values in both packages makes them with numpy.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["seed", "generator", "host_rng"]

_lock = threading.Lock()
_STATE = {"seed": None, "gens": {}, "host": None}


def seed(seed_state):
    """Seed every device's generator and the host stream with
    ``seed_state`` (parity with ``mx.random.seed``)."""
    s = int(seed_state)
    with _lock:
        _STATE["seed"] = s
        _STATE["gens"] = {}
        _STATE["host"] = _np.random.RandomState(s & 0xFFFFFFFF)


def generator(device) -> torch.Generator:
    """The ``torch.Generator`` of ``device`` (a ``torch.device``)."""
    device = torch.device(device)
    key = (device.type, device.index or 0)
    with _lock:
        gen = _STATE["gens"].get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            if _STATE["seed"] is None:
                gen.seed()
            else:
                gen.manual_seed(_STATE["seed"])
            _STATE["gens"][key] = gen
        return gen


def host_rng() -> _np.random.RandomState:
    """The host-side numpy stream (shuffles of the data iterators)."""
    with _lock:
        if _STATE["host"] is None:
            _STATE["host"] = _np.random.RandomState()
        return _STATE["host"]
