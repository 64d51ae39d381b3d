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

Contract for a kind's ``apply(w32, g, inner, lr, wd, rescale,
use_wd)``:

* ``w32`` is the weight in f32 (the f32 master under multi-precision);
* ``g`` is the raw f32 reduced gradient: each kind runs its own
  gradient pipeline (rescale, clip, weight decay in its eager op's
  order);
* ``inner`` is the optimizer state in its nesting (None, a tensor or a
  tuple), and the same nesting comes back;
* ``lr``, ``wd`` and ``rescale`` are runtime values (0-d tensors in the
  captured step, so a schedule never captures again);
* ``use_wd`` is static: the eager ops skip the weight-decay term when
  ``wd`` is 0 (``if wd:``).

Functions take tensors and return new ones; the fit step copies the
results into the live weights and states in place.  The JAX package's
kinds for LBSGD, Adamax, Nadam and LAMB wait for those optimizers
(ROADMAP A.5), its ``DynamicLossScaler`` for low-precision ``Module``
training (A.1).
"""
from __future__ import annotations

import torch

__all__ = ["build", "supported", "apply_one", "bulk_apply", "flatten_state",
           "state_template", "unflatten", "register_kind"]


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
    """One kind's pure per-key apply."""

    __slots__ = ("kind", "apply")

    def __init__(self, kind, apply):
        self.kind = kind
        self.apply = apply


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

    def apply(w32, g, inner, lr, wd, rescale, use_wd):
        g = _common(g, w32, wd, rescale, clip, use_wd)
        if inner is not None:
            new_mom = momentum * inner.float() - lr * g
            return w32 + new_mom, new_mom
        return w32 - lr * g, None
    return _FusedUpdate("sgd", apply)


@register_kind("adam")
def _adam(sig):
    # the bias correction is folded into lr on the host
    # (Adam._fused_lr), as the eager update folds it
    _, beta1, beta2, epsilon, clip = sig

    def apply(w32, g, inner, lr, wd, rescale, use_wd):
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

    def apply(w32, g, inner, lr, wd, rescale, use_wd):
        # adagrad_update applies wd inside the step term, not on g
        g = _clip(g * rescale, clip)
        new_h = inner + g.square()
        new_w = w32 - lr * (g / torch.sqrt(new_h + epsilon) + wd * w32)
        return new_w, new_h
    return _FusedUpdate("adagrad", apply)


@register_kind("rmsprop")
def _rmsprop(sig):
    _, gamma1, epsilon, clip, clip_weights = sig

    def apply(w32, g, inner, lr, wd, rescale, use_wd):
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

    def apply(w32, gr, inner, lr, wd, rescale, use_wd):
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


# ----------------------------------------------------------------------
# the per-key wrapper (multi-precision aware)
# ----------------------------------------------------------------------
def apply_one(upd, w, g, state, mp, lr, wd, rescale, use_wd):
    """One key's fused update: ``(new_w, new_state)``, every leaf in its
    input's dtype.  ``mp`` (static) says the state is ``(inner,
    weight32)`` and ``w`` the low-precision weight, which comes back as
    the updated master rounded to its type."""
    g32 = g.float()
    if mp:
        inner, w32 = state
    else:
        inner, w32 = state, w.float()
    new_w32, new_inner = upd.apply(w32, g32, inner, lr, wd, rescale, use_wd)
    new_state = (new_inner, new_w32) if mp else new_inner
    old_leaves = flatten_state(state)[0]
    new_leaves, tpl = flatten_state(new_state)
    cast = [n.to(o.dtype) for n, o in zip(new_leaves, old_leaves)]
    return new_w32.to(w.dtype), unflatten(tpl, cast)


def bulk_apply(sig):
    """The update of ``sig`` over aligned per-key sequences:
    ``fused_update(params, grads, states, runtime_scalars)`` returns
    ``(new_params, new_states)``.  ``runtime_scalars`` carries the
    per-key ``lr`` and ``wd``, the ``rescale`` scalar, the static
    per-key ``mp`` flags and the static ``use_wd``."""
    upd = build(sig)

    def fused_update(params, grads, states, runtime_scalars):
        rt = runtime_scalars
        lr, wd, rescale = rt["lr"], rt["wd"], rt["rescale"]
        mp = rt.get("mp") or (False,) * len(params)
        use_wd = rt.get("use_wd", True)
        new_ps, new_ss = [], []
        for i, (w, g, st) in enumerate(zip(params, grads, states)):
            nw, ns = apply_one(upd, w, g, st, mp[i], lr[i], wd[i], rescale,
                               use_wd)
            new_ps.append(nw)
            new_ss.append(ns)
        return tuple(new_ps), tuple(new_ss)
    return fused_update
