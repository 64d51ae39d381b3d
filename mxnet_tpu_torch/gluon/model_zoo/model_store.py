"""Pretrained weights (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).  The repository holds no
store of weights and the port fetches none, so every factory's
``pretrained=True`` raises here, as the JAX package's does when its
local file is missing; carry weights in with
``weights.gluon_params_from_numpy`` or ``load_parameters``."""
from ...base import MXNetError

__all__ = ["no_pretrained"]


def no_pretrained(name):
    raise MXNetError("pretrained weights for '%s': the PyTorch port has no "
                     "store of weights (and no network to fetch them); load "
                     "numpy weights with weights.gluon_params_from_numpy or "
                     "a .params file with load_parameters" % name)
