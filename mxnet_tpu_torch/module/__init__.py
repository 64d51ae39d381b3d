"""Module: the mid-level training API (counterpart of
``mxnet_tpu/module``): ``Module``, ``SequentialModule`` and
``BucketingModule`` (one module a sequence length, sharing weights
through ``bind(shared_module=...)``)."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "Module", "SequentialModule", "BucketingModule"]
