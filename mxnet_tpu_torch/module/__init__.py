"""Module: the mid-level training API (counterpart of
``mxnet_tpu/module``).  ``BucketingModule`` (one module a sequence
length, sharing weights through ``bind(shared_module=...)``) comes with
the RNN slice and raises."""
from ..base import MXNetError
from .base_module import BaseModule
from .module import Module
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "SequentialModule", "BucketingModule"]


class BucketingModule(BaseModule):
    """Waits for the RNN slice (ROADMAP A.6): its users are the RNN
    LMs of ``example/rnn``, and the transformer LM's position embedding
    has one size a sequence length."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("BucketingModule comes with the bucketing and RNN "
                         "slice of the PyTorch port (ROADMAP A.6)")
