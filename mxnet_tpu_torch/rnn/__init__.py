"""``mx.rnn``: the symbolic RNN toolkit (counterpart of
``mxnet_tpu/rnn``, reference python/mxnet/rnn): the step cells and
their combinators, ``FusedRNNCell`` over the fused ``sym.RNN`` op and
the pack/unpack bridge between the two (``rnn_cell.py``), the bucketing
sentence iterator (``io.py``) and the per-gate checkpoints (``rnn.py``).
"""
from .io import BucketSentenceIter, encode_sentences
from .rnn import do_rnn_checkpoint, load_rnn_checkpoint, save_rnn_checkpoint
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams, SequentialRNNCell,
                       ZoneoutCell)

__all__ = ["BucketSentenceIter", "encode_sentences",
           "save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint",
           "RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]
