"""Name scopes of symbols and Gluon blocks (``mx.name``).

Counterpart of ``mxnet_tpu/name.py`` (reference python/mxnet/name.py):
``NameManager``, ``Prefix`` and ``current``.  They are the managers of
``base.py``, whose one stack a thread's symbols and blocks take their
names from, so ``with mx.name.Prefix("enc_"):`` prefixes every symbol
and block made inside it.  (The JAX package's ``mx.name`` keeps a second
stack that its symbol layer does not read; its ``base.Prefix`` is the
one that names symbols there, and the port names them as it does.)
"""
from __future__ import annotations

from .base import NameManager, Prefix, current_name_manager

__all__ = ["NameManager", "Prefix", "current"]


def current():
    """The innermost active manager of this thread (the process-wide
    one outside every scope)."""
    return current_name_manager()
