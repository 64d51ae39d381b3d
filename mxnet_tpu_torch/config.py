"""The ``MXNET_*`` environment variables the port reads (``mx.config``).

Counterpart of ``mxnet_tpu/config.py``.  The reference configures its
runtime only through ``MXNET_*`` variables read at start-up
(docs/faq/env_var.md).  ``_KNOWN`` lists each variable the port reads,
with its default, whether it changes what the port does (wired) or is
accepted and changes nothing (inert), and a note; :func:`summary`
prints the table with the current values.

- ``MXNET_BACKWARD_DO_MIRROR=1``: gradient mirroring (the reference's
  graph_executor.cc:193), compute traded for activation memory.  An
  executor snapshots it at ``simple_bind``/``bind``; its train forward
  then keeps only the graph's inputs and its backward recomputes the
  forward before taking the gradients (``executor.py``).  The fused fit
  step reads it at each step and recomputes the forward inside its
  graph (``module/fused_fit.py``).
"""
from __future__ import annotations

import os

__all__ = ["env_bool", "naive_engine", "backward_do_mirror", "summary"]

# name -> (default, wired?, note)
_KNOWN = {
    "MXNET_BACKWARD_DO_MIRROR": ("0", True,
                                 "1 = recompute the forward in the backward "
                                 "(snapshot at bind; the fused fit step "
                                 "reads it each step)"),
    "MXNET_FIT_FUSED": ("1", True, "0 = Module.fit keeps the eager forward/"
                        "backward/update pair (no CUDA graph)"),
    "MXNET_FIT_SYNC_EVERY": ("0", True, "n = the fit loop waits for the "
                             "device every n batches"),
    "MXNET_KVSTORE_FUSED": ("1", True, "0 = the device kvstore updates "
                            "key by key instead of by flat buckets"),
    "MXNET_KVSTORE_BIGARRAY_BOUND": ("4194304", True,
                                     "the kvstore's flat bucket cap in "
                                     "bytes"),
    "MXNET_LOSS_SCALE": ("dynamic", True, "the fused step's 16-bit overflow "
                         "check: dynamic, a fixed scale, or off"),
    "MXNET_LOSS_SCALE_INIT": ("32768.0", True, "the dynamic scale's "
                              "start"),
    "MXNET_LOSS_SCALE_GROWTH_INTERVAL": ("2000", True,
                                         "finite steps before the dynamic "
                                         "scale doubles"),
    "MXNET_CHECKPOINT_EVERY": ("0", True, "n = Module.fit checkpoints "
                               "every n steps (mx.checkpoint)"),
    "MXNET_CHECKPOINT_PREFIX": ("checkpoint", True, "the prefix of fit's "
                                "checkpoints"),
    "MXNET_CHECKPOINT_KEEP": ("3", True, "checkpoints kept on disk"),
    "MXNET_CHECKPOINT_PREEMPT": ("1", True, "0 = no SIGTERM handler that "
                                 "checkpoints before exit"),
    "MXNET_DECODE_DONATE": ("1", True, "0 = the decode engine's steps run "
                            "eagerly, not as captured CUDA graphs"),
    "MXNET_DECODE_SPEC_K": ("0", True, "tokens the engine drafts a step "
                            "(0 = no speculation)"),
    "MXNET_DECODE_SPEC_IMPL": ("auto", True, "the drafter: auto, ngram or "
                               "draft"),
    "MXNET_DECODE_ACCEPT_WINDOW": ("256", True, "steps the accept rate is "
                                   "averaged over"),
    "MXNET_ENGINE_TYPE": ("ThreadedEnginePerDevice", False,
                          "PyTorch orders the port's work on its streams; "
                          "NaiveEngine changes nothing"),
    "MXNET_SENTINEL_NUMERICS": ("0", False, "the in-launch numerics "
                                "sentinels: other than 0 raises in the fused "
                                "fit step (ROADMAP A.9)"),
}


def env_bool(name, default=False):
    return os.environ.get(name, "1" if default else "0") in ("1", "true",
                                                             "True")


def naive_engine():
    """True when ``MXNET_ENGINE_TYPE`` asks for the reference's
    synchronous NaiveEngine (inert in the port: see ``_KNOWN``)."""
    return os.environ.get("MXNET_ENGINE_TYPE", "") == "NaiveEngine"


def backward_do_mirror():
    """True when a backward recomputes the forward
    (``MXNET_BACKWARD_DO_MIRROR``)."""
    return env_bool("MXNET_BACKWARD_DO_MIRROR")


def summary():
    """The current value of every known variable, whether the port acts
    on it, and its note, one line each."""
    lines = ["%-36s %-10s %-6s %s" % ("Variable", "Value", "Wired", "Notes")]
    for name, (default, wired, doc) in sorted(_KNOWN.items()):
        lines.append("%-36s %-10s %-6s %s"
                     % (name, os.environ.get(name, default),
                        "yes" if wired else "inert", doc))
    return "\n".join(lines)
