"""RNN checkpoints: ``save_rnn_checkpoint`` writes each cell's weights
unpacked to per-gate arrays, ``load_rnn_checkpoint`` packs them back for
the cells (or the fused op) that load them, and ``do_rnn_checkpoint`` is
the epoch-end callback form.  Counterpart of ``mxnet_tpu/rnn/rnn.py``
(reference python/mxnet/rnn/rnn.py); the files are the JAX package's.
"""
from __future__ import annotations

from ..model import load_checkpoint, save_checkpoint
from .rnn_cell import BaseRNNCell

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cell_list(cells):
    return [cells] if isinstance(cells, BaseRNNCell) else list(cells)


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Save ``prefix-symbol.json`` + ``prefix-NNNN.params`` with every
    cell's weights unpacked to per-gate entries."""
    for cell in _cell_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """Load a checkpoint saved by :func:`save_rnn_checkpoint`, re-packing
    per-gate entries into each cell's stacked/fused layout."""
    sym, arg, aux = load_checkpoint(prefix, epoch)
    for cell in _cell_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback version of :func:`save_rnn_checkpoint`."""
    stride = max(int(period), 1)

    def _on_epoch_end(epoch, sym, arg, aux):
        done = epoch + 1
        if done % stride == 0:
            save_rnn_checkpoint(cells, prefix, done, sym, arg, aux)
    return _on_epoch_end
