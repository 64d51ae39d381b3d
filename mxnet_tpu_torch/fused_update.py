"""The fused optimizer update: one pure function per kind of update.

Counterpart of ``mxnet_tpu/fused_update.py:62-406``.  An optimizer
describes its update as a hashable ``Optimizer._fused_sig()`` tuple
``(kind, *hyperparameters)``; this module turns the tuple into the pure
per-key update that ``Module``'s single-launch fit step
(``module/fused_fit.py``) applies inside its CUDA graph.  The JAX
package's compiled engines consume the same description; the port's
kvstore applies bucketable optimizers through their eager per-key ops
(``kvstore_fused.py``), which stay the parity oracle: each kind here
is the op sequence of ``ops/optimizer_ops.py``, so fused and eager
weights agree to the last bit on the same gradients.

Contract for a kind's ``apply(w32, g, inner, lr, wd, rescale, extra,
use_wd)``:

* ``w32`` is the weight in f32 (the f32 master under multi-precision);
* ``g`` is the raw f32 reduced gradient: each kind runs its own
  gradient pipeline (rescale, clip, weight decay in its eager op's
  order);
* ``inner`` is the optimizer state in its nesting (None, a tensor or a
  tuple), and the same nesting comes back;
* ``lr``, ``wd`` and ``rescale`` are runtime values (0-d tensors in the
  captured step, so a schedule never captures again), and so are the
  kind's ``n_extra`` per-key ``extra`` scalars (Nadam's schedule
  products, LAMB's bias corrections: ``Optimizer._fused_extra``, which
  advances the optimizer's host state in key order as the eager
  updates would);
* ``use_wd`` is static: the eager ops skip the weight-decay term when
  ``wd`` is 0 (``if wd:``).

Functions take tensors and return new ones; the fit step and the
bucketed kvstore copy the results into the live weights and states in
place.  LBSGD's and LAMB's norms are device reductions here (their
eager updates read them to the host); a step's trust ratio comes from
the f32 master under multi-precision.

This module also keeps :class:`DynamicLossScaler` (counterpart of
``mxnet_tpu/fused_update.py:395-540``), the loss-scale state of
low-precision fused training: ``(scale, good steps, skips)`` as three
0-d tensors on the device that the fit step's graph updates in place;
the ``loss_scale`` gauge and the ``loss_scale_overflow_skips`` counter
are published only at sync points (``publish``).
"""
from __future__ import annotations

import os

import torch

from .base import LOW_PRECISION
from .telemetry import REGISTRY

__all__ = ["build", "supported", "apply_one", "bulk_apply", "flatten_state",
           "state_template", "unflatten", "register_kind",
           "is_low_precision", "DynamicLossScaler", "scaler_config",
           "LOSS_SCALE", "OVERFLOW_SKIPS"]


def is_low_precision(dtype):
    """Whether ``dtype`` (a torch dtype) gets an f32 master under
    ``multi_precision`` and a loss scaler in the fused fit step."""
    return dtype in LOW_PRECISION


# ----------------------------------------------------------------------
# state flattening: optimizer state -> ordered leaves + hashable template
# ----------------------------------------------------------------------
def flatten_state(state):
    """``(leaves, template)`` of a nested optimizer state (tuples,
    arrays, None): the array leaves in order and a hashable descriptor
    of the nesting (``None`` for an absent leaf, ``"a"`` for an array,
    ``("t", ...)`` for a tuple)."""
    if state is None:
        return [], None
    if isinstance(state, tuple):
        leaves, tpls = [], []
        for s in state:
            sub, t = flatten_state(s)
            leaves.extend(sub)
            tpls.append(t)
        return leaves, ("t",) + tuple(tpls)
    return [state], "a"


def state_template(state):
    return flatten_state(state)[1]


def unflatten(tpl, leaves):
    """Inverse of :func:`flatten_state`."""
    it = iter(leaves)

    def rec(t):
        if t is None:
            return None
        if t == "a":
            return next(it)
        return tuple(rec(s) for s in t[1:])
    return rec(tpl)


# ----------------------------------------------------------------------
# the kind registry
# ----------------------------------------------------------------------
class _FusedUpdate:
    """One kind's pure per-key apply and the number of per-key extra
    runtime scalars it reads."""

    __slots__ = ("kind", "apply", "n_extra")

    def __init__(self, kind, apply, n_extra=0):
        self.kind = kind
        self.apply = apply
        self.n_extra = n_extra


_KINDS = {}
_BUILT = {}


def register_kind(kind):
    def deco(builder):
        _KINDS[kind] = builder
        return builder
    return deco


def supported(sig):
    """True when ``sig`` names a registered kind."""
    return bool(sig) and sig[0] in _KINDS


def build(sig):
    """``sig`` (an ``Optimizer._fused_sig()`` tuple) -> its cached
    :class:`_FusedUpdate`; KeyError for an unknown kind (callers check
    :func:`supported` first)."""
    upd = _BUILT.get(sig)
    if upd is None:
        upd = _BUILT[sig] = _KINDS[sig[0]](sig)
    return upd


def _clip(g, clip):
    if clip is not None and clip >= 0:
        return g.clamp(-clip, clip)
    return g


def _common(g, w32, wd, rescale, clip, use_wd):
    """``ops/optimizer_ops.py`` ``_apply_common``: rescale, clip, wd."""
    g = _clip(g * rescale, clip)
    if use_wd:
        g = g + wd * w32
    return g


@register_kind("sgd")
def _sgd(sig):
    _, momentum, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        g = _common(g, w32, wd, rescale, clip, use_wd)
        if inner is not None:
            new_mom = momentum * inner.float() - lr * g
            return w32 + new_mom, new_mom
        return w32 - lr * g, None
    return _FusedUpdate("sgd", apply)


def _norm(t):
    return t.square().sum().sqrt()


@register_kind("lbsgd")
def _lbsgd(sig):
    """SGD with momentum and LARS's layer-wise coefficient, its norms
    reduced on the device (the eager update reads them to the host)."""
    _, momentum, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        # the eager _get_lars takes the raw (not rescaled) gradient
        w_norm, g_norm = _norm(w32), _norm(g)
        lars = torch.where((w_norm > 0) & (g_norm > 0),
                           w_norm / (g_norm + wd * w_norm + 1e-9) * 0.001,
                           torch.ones_like(w_norm))
        lr = lr * lars
        g = _common(g, w32, wd, rescale, clip, use_wd)
        if inner is not None:
            new_mom = momentum * inner.float() - lr * g
            return w32 + new_mom, new_mom
        return w32 - lr * g, None
    return _FusedUpdate("lbsgd", apply)


@register_kind("adam")
def _adam(sig):
    # the bias correction is folded into lr on the host
    # (Adam._fused_lr), as the eager update folds it
    _, beta1, beta2, epsilon, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        g = _common(g, w32, wd, rescale, clip, use_wd)
        mean, var = inner
        new_mean = beta1 * mean + (1 - beta1) * g
        new_var = beta2 * var + (1 - beta2) * g * g
        new_w = w32 - lr * new_mean / (new_var.sqrt() + epsilon)
        return new_w, (new_mean, new_var)
    return _FusedUpdate("adam", apply)


@register_kind("adagrad")
def _adagrad(sig):
    _, epsilon, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        # adagrad_update applies wd inside the step term, not on g
        g = _clip(g * rescale, clip)
        new_h = inner + g.square()
        new_w = w32 - lr * (g / torch.sqrt(new_h + epsilon) + wd * w32)
        return new_w, new_h
    return _FusedUpdate("adagrad", apply)


@register_kind("rmsprop")
def _rmsprop(sig):
    _, gamma1, epsilon, clip, clip_weights = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        g = _common(g, w32, wd, rescale, clip, use_wd)
        new_n = (1 - gamma1) * g.square() + gamma1 * inner
        new_w = w32 - lr * g / torch.sqrt(new_n + epsilon)
        if clip_weights is not None and clip_weights > 0:
            new_w = new_w.clamp(-clip_weights, clip_weights)
        return new_w, new_n
    return _FusedUpdate("rmsprop", apply)


@register_kind("rmspropalex")
def _rmspropalex(sig):
    # clip_weights applies here as in the JAX package's fused kind; its
    # eager op (and the port's, ops/optimizer_ops.py) accepts it and
    # does not apply it
    _, gamma1, gamma2, epsilon, clip, clip_weights = sig

    def apply(w32, gr, inner, lr, wd, rescale, extra, use_wd):
        gr = _common(gr, w32, wd, rescale, clip, use_wd)
        n, gacc, delta = inner
        new_n = (1 - gamma1) * gr.square() + gamma1 * n
        new_g = (1 - gamma1) * gr + gamma1 * gacc
        new_delta = (gamma2 * delta - lr * gr
                     / torch.sqrt(new_n - new_g.square() + epsilon))
        new_w = w32 + new_delta
        if clip_weights is not None and clip_weights > 0:
            new_w = new_w.clamp(-clip_weights, clip_weights)
        return new_w, (new_n, new_g, new_delta)
    return _FusedUpdate("rmspropalex", apply)


@register_kind("adamax")
def _adamax(sig):
    # lr arrives divided by (1 - beta1^t) (Adamax._fused_lr)
    _, beta1, beta2, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        # the eager Adamax: rescale, + wd * w (always), then clip
        g = _clip(g * rescale + wd * w32, clip)
        m, u = inner
        new_m = beta1 * m + (1.0 - beta1) * g
        new_u = torch.maximum(beta2 * u, g.abs())
        return w32 - lr * new_m / new_u, (new_m, new_u)
    return _FusedUpdate("adamax", apply)


@register_kind("nadam")
def _nadam(sig):
    # extra = (momentum_t, momentum_t_1, m_schedule, m_schedule_next,
    # 1 - beta2^t), from Nadam._fused_extra in key order (the schedule
    # product is host state that each key's update advances)
    _, beta1, beta2, epsilon, _schedule_decay, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        momentum_t, momentum_t_1, m_schedule, m_schedule_next, bc2 = extra
        g = _clip(g * rescale + wd * w32, clip)
        m, v = inner
        new_m = beta1 * m + (1.0 - beta1) * g
        new_v = beta2 * v + (1.0 - beta2) * g.square()
        grad_prime = g / (1.0 - m_schedule)
        m_prime = new_m / (1.0 - m_schedule_next)
        v_prime = new_v / bc2
        m_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_prime
        new_w = w32 - lr * m_bar / (v_prime.sqrt() + epsilon)
        return new_w, (new_m, new_v)
    return _FusedUpdate("nadam", apply, n_extra=5)


@register_kind("lamb")
def _lamb(sig):
    # extra = (1 - beta1^t, 1 - beta2^t), read with bias_correction
    _, beta1, beta2, epsilon, bias_correction, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, extra, use_wd):
        g = _clip(g * rescale, clip)
        m, v = inner
        new_m = beta1 * m + (1.0 - beta1) * g
        new_v = beta2 * v + (1.0 - beta2) * g.square()
        if bias_correction:
            m_hat, v_hat = new_m / extra[0], new_v / extra[1]
        else:
            m_hat, v_hat = new_m, new_v
        r = m_hat / (v_hat.sqrt() + epsilon) + wd * w32
        w_norm, r_norm = _norm(w32), _norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        return w32 - lr * ratio * r, (new_m, new_v)
    return _FusedUpdate("lamb", apply, n_extra=2)


# ----------------------------------------------------------------------
# the per-key wrapper (multi-precision aware)
# ----------------------------------------------------------------------
def apply_one(upd, w, g, state, mp, lr, wd, rescale, extra, use_wd):
    """One key's fused update: ``(new_w, new_state)``, every leaf in its
    input's dtype.  ``mp`` (static) says the state is ``(inner,
    weight32)`` and ``w`` the low-precision weight, which comes back as
    the updated master rounded to its type; ``extra`` is the key's
    ``upd.n_extra`` runtime scalars (a sequence, empty for most
    kinds)."""
    g32 = g.float()
    if mp:
        inner, w32 = state
    else:
        inner, w32 = state, w.float()
    new_w32, new_inner = upd.apply(w32, g32, inner, lr, wd, rescale, extra,
                                   use_wd)
    new_state = (new_inner, new_w32) if mp else new_inner
    old_leaves = flatten_state(state)[0]
    new_leaves, tpl = flatten_state(new_state)
    cast = [n.to(o.dtype) for n, o in zip(new_leaves, old_leaves)]
    return new_w32.to(w.dtype), unflatten(tpl, cast)


def bulk_apply(sig):
    """The update of ``sig`` over aligned per-key sequences:
    ``fused_update(params, grads, states, runtime_scalars)`` returns
    ``(new_params, new_states)``.  ``runtime_scalars`` carries the
    per-key ``lr`` and ``wd``, the ``rescale`` scalar, the ``extra``
    (n_keys, n_extra) matrix of the kinds that read one, the static
    per-key ``mp`` flags and the static ``use_wd`` (one flag, or one per
    key as the eager ops' ``if wd:`` decides it)."""
    upd = build(sig)

    def fused_update(params, grads, states, runtime_scalars):
        rt = runtime_scalars
        lr, wd, rescale = rt["lr"], rt["wd"], rt["rescale"]
        extra = rt.get("extra")
        mp = rt.get("mp") or (False,) * len(params)
        use_wd = rt.get("use_wd", True)
        if isinstance(use_wd, bool):
            use_wd = (use_wd,) * len(params)
        new_ps, new_ss = [], []
        for i, (w, g, st) in enumerate(zip(params, grads, states)):
            nw, ns = apply_one(upd, w, g, st, mp[i], lr[i], wd[i], rescale,
                               extra[i] if upd.n_extra else (), use_wd[i])
            new_ps.append(nw)
            new_ss.append(ns)
        return tuple(new_ps), tuple(new_ss)
    return fused_update


# ----------------------------------------------------------------------
# dynamic loss scaling (16-bit training through the fused fit step)
# ----------------------------------------------------------------------
LOSS_SCALE = REGISTRY.gauge(
    "loss_scale",
    "current dynamic loss scale of the fused fit step (published at sync "
    "points; the live value is on the device)")
OVERFLOW_SKIPS = REGISTRY.counter(
    "loss_scale_overflow_skips",
    "fused fit steps whose update was skipped because a gradient was "
    "not finite (the loss scale backs off)")


def scaler_config():
    """The loss-scaling knobs: ``MXNET_LOSS_SCALE`` is ``dynamic`` (the
    default), ``off``, or a number for a static scale (which still skips
    a non-finite step, and never changes); ``MXNET_LOSS_SCALE_INIT``
    (2^15) and ``MXNET_LOSS_SCALE_GROWTH_INTERVAL`` (2000).  None when
    scaling is off."""
    mode = os.environ.get("MXNET_LOSS_SCALE", "dynamic").strip().lower()
    if mode in ("off", "none", "0", ""):
        return None
    init = float(os.environ.get("MXNET_LOSS_SCALE_INIT", str(2.0 ** 15)))
    interval = int(os.environ.get("MXNET_LOSS_SCALE_GROWTH_INTERVAL",
                                  "2000"))
    if mode == "dynamic":
        return {"dynamic": True, "init": init, "interval": interval}
    return {"dynamic": False, "init": float(mode), "interval": interval}


class DynamicLossScaler:
    """Loss-scale state of low-precision fused training.  The live
    ``(scale f32, good i32, skips i32)`` triple is three 0-d tensors on
    the device, updated in place by :meth:`step_fn` inside the fit
    step's graph; the host copies change only in :meth:`publish` (a
    host sync, made at sync points only).  The scale grows 2x after
    ``growth_interval`` finite steps in a row, up to 2^24, and halves
    (not below 1) on a non-finite step; a static scaler keeps its scale
    and still counts skips.  As in the JAX package the loss itself is
    not scaled (the loss heads make their own gradient): the scaler's
    use is the detection of a non-finite step, which the fit step
    skips."""

    GROWTH = 2.0
    BACKOFF = 0.5
    MAX_SCALE = 2.0 ** 24

    def __init__(self, init_scale=None, growth_interval=None, dynamic=True):
        cfg = scaler_config() or {"dynamic": True, "init": 2.0 ** 15,
                                  "interval": 2000}
        self.dynamic = bool(dynamic if dynamic is not None
                            else cfg["dynamic"])
        self._scale = float(init_scale if init_scale is not None
                            else cfg["init"])
        self.growth_interval = int(growth_interval
                                   if growth_interval is not None
                                   else cfg["interval"])
        self._good = 0
        self._skips = 0
        self._published_skips = 0
        self._dev = None        # the live (scale, good, skips) tensors

    @classmethod
    def from_config(cls):
        """A scaler from :func:`scaler_config`, or None when it is off."""
        cfg = scaler_config()
        if cfg is None:
            return None
        return cls(init_scale=cfg["init"], growth_interval=cfg["interval"],
                   dynamic=cfg["dynamic"])

    def trace_sig(self):
        """What a captured step's arithmetic depends on."""
        return ("lscale", self.dynamic, self.growth_interval, self.GROWTH,
                self.BACKOFF, self.MAX_SCALE)

    def device_state(self, device="cpu"):
        """The live triple, made on ``device`` from the host values at
        first use."""
        if self._dev is None:
            self._dev = (
                torch.tensor(self._scale, dtype=torch.float32, device=device),
                torch.tensor(self._good, dtype=torch.int32, device=device),
                torch.tensor(self._skips, dtype=torch.int32, device=device))
        return self._dev

    @torch.no_grad()
    def step_fn(self, finite, state):
        """One step's bookkeeping, in place on ``state`` (returned):
        ``finite`` is a 0-d bool tensor (or a bool)."""
        scale, good, skips = state
        finite = torch.as_tensor(finite, device=scale.device)
        skips.add_((~finite).to(skips.dtype))
        if not self.dynamic:
            return state
        new_good = torch.where(finite, good + 1, torch.zeros_like(good))
        grow = new_good >= self.growth_interval
        grown = torch.clamp(scale * self.GROWTH, max=self.MAX_SCALE)
        new_scale = torch.where(finite, torch.where(grow, grown, scale),
                                torch.clamp(scale * self.BACKOFF, min=1.0))
        good.copy_(torch.where(grow, torch.zeros_like(new_good), new_good))
        scale.copy_(new_scale)
        return state

    def publish(self):
        """Read the live triple into the host copies and publish the
        ``loss_scale`` gauge and the new skips to
        ``loss_scale_overflow_skips``; returns the scale.  A host sync:
        call it only at sync points."""
        if self._dev is not None:
            scale, good, skips = self._dev
            self._scale = float(scale.item())
            self._good = int(good.item())
            self._skips = int(skips.item())
        LOSS_SCALE.set(self._scale)
        delta = self._skips - self._published_skips
        if delta > 0:
            OVERFLOW_SKIPS.inc(delta)
        self._published_skips = self._skips
        return self._scale

    @property
    def scale(self):
        return self._scale

    @property
    def skips(self):
        return self._skips

    def state_dict(self):
        self.publish()
        return {"scale": self._scale, "good": self._good,
                "skips": self._skips, "dynamic": self.dynamic,
                "growth_interval": self.growth_interval}

    def load_state_dict(self, d):
        """Restore :meth:`state_dict`'s values; a live triple takes them
        in place (a captured step keeps reading the same tensors)."""
        self._scale = float(d.get("scale", self._scale))
        self._good = int(d.get("good", 0))
        self._skips = int(d.get("skips", 0))
        self.dynamic = bool(d.get("dynamic", self.dynamic))
        self.growth_interval = int(d.get("growth_interval",
                                         self.growth_interval))
        self._published_skips = self._skips
        if self._dev is not None:
            for t, v in zip(self._dev, (self._scale, self._good,
                                        self._skips)):
                t.fill_(v)

    @classmethod
    def from_state(cls, d):
        s = cls()
        s.load_state_dict(d)
        return s
