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

``get_state``/``set_state`` snapshot and restore every stream (a
checkpoint carries them): the seed, each generator's state and the host
stream's Mersenne state.  The dict has the JAX package's keys
(``seed``, ``key``, ``host``) plus ``torch``; ``key`` is always None
here.  Across packages only the host stream carries over (the data
iterators' shuffle order): a device stream of one package cannot be
set in the other, so a restore from the other package's checkpoint
seeds the generators from its seed.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

__all__ = ["seed", "generator", "host_rng", "get_state", "set_state",
           "next_seed", "StepRandom", "keep_mask"]

_lock = threading.Lock()
_STATE = {"seed": None, "gens": {}, "host": None}


def seed(seed_state):
    """Seed every device's generator and the host stream with
    ``seed_state`` (parity with ``mx.random.seed``).  A generator made
    already is re-seeded in place, so whatever holds it (a captured
    step's seed draw) follows the new seed."""
    s = int(seed_state)
    with _lock:
        _STATE["seed"] = s
        for gen in _STATE["gens"].values():
            gen.manual_seed(s)
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


def get_state():
    """``{"seed", "key": None, "host", "torch"}``: the seed (None when
    never seeded), the host stream's ``get_state()`` tuple and each
    generator made so far as ``{"cuda:0": uint8 numpy}``."""
    with _lock:
        host = _STATE["host"]
        return {"seed": _STATE["seed"], "key": None,
                "host": None if host is None else host.get_state(),
                "torch": {"%s:%d" % key: gen.get_state().numpy().copy()
                          for key, gen in _STATE["gens"].items()}}


def set_state(state):
    """Restore a :func:`get_state` snapshot (or the JAX package's, whose
    device key is ignored): the seed, the host stream, and each
    generator it holds; generators it does not hold start from the
    seed."""
    s = state.get("seed")
    host = state.get("host")
    gens = state.get("torch") or {}
    with _lock:
        _STATE["seed"] = None if s is None else int(s)
        for gen in _STATE["gens"].values():
            if s is None:
                gen.seed()
            else:
                gen.manual_seed(int(s))
        if host is None:
            _STATE["host"] = None
        else:
            rng = _np.random.RandomState()
            rng.set_state(tuple(host))
            _STATE["host"] = rng
    for key, value in gens.items():
        kind, idx = key.split(":")
        device = torch.device(kind, int(idx)) if kind != "cpu" \
            else torch.device("cpu")
        if device.type == "cuda" and not torch.cuda.is_available():
            continue
        generator(device).set_state(
            torch.from_numpy(_np.asarray(value, dtype=_np.uint8)).clone())


# ----------------------------------------------------------------------
# per-step seeds and the counter-based draw
# ----------------------------------------------------------------------
_SEED_HIGH = 2 ** 31 - 1
_M32 = 0xFFFFFFFF
# Mueller's 32-bit mixing constant: below 2^27, so a 32-bit value times
# it stays inside int64 and every product is exact on any device
_MIX = 0x45D9F3B
_GOLDEN = 0x9E3779B9


def next_seed(device, out=None):
    """A fresh step seed in [0, 2^31 - 1) drawn from ``device``'s
    generator into ``out`` (a 0-d int64 tensor on ``device``; a new one
    when None), without a host sync.  Returns the tensor."""
    device = torch.device(device)
    if out is None:
        out = torch.empty((), dtype=torch.int64, device=device)
    return out.random_(0, _SEED_HIGH, generator=generator(device))


class StepRandom:
    """The draws of one walk: its step seed (a 0-d int64 tensor) and the
    number of sites that drew so far.  Ops that declare ``rng`` are
    handed the walk's instance and take ``(seed, site)`` from
    :meth:`next`, in the walk's order, so every replay of a step draws
    the same sites from the seed staged for it."""

    __slots__ = ("seed", "site")

    def __init__(self, seed):
        self.seed = seed
        self.site = 0

    def next(self):
        site = self.site
        self.site += 1
        return self.seed, site


def _mix(x):
    """Two rounds of Mueller's 32-bit integer hash on an int64 tensor of
    values in [0, 2^32), in place; the high bits come out mixed best."""
    for _ in range(2):
        x.bitwise_xor_(x >> 16).mul_(_MIX).bitwise_and_(_M32)
    return x


def _mix_int(x):
    """:func:`_mix` on a Python int."""
    for _ in range(2):
        x = ((x ^ (x >> 16)) * _MIX) & _M32
    return x


def keep_mask(seed, site, shape, keep, device):
    """A bool tensor of ``shape`` on ``device``, each element True with
    probability ``keep`` (to within 2^-32), drawn from the step seed
    ``seed`` (a 0-d int64 tensor) at draw site ``site``: the element's
    flat index XOR a key mixed from both, hashed, compared with
    ``keep * 2^32``.  Integer arithmetic only, so the bits do not depend
    on the device."""
    n = 1
    for s in shape:
        n *= int(s)
    key = _mix((seed.to(device=device, dtype=torch.int64)
                ^ _mix_int((site * _GOLDEN + 1) & _M32)) & _M32)
    bits = torch.arange(n, dtype=torch.int64, device=device)
    bits.bitwise_xor_(key).bitwise_and_(_M32)
    return (_mix(bits) < int(keep * 2.0 ** 32)).view(tuple(shape))
