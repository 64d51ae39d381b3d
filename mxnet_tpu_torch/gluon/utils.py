"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``,
reference python/mxnet/gluon/utils.py): ``split_data``,
``split_and_load`` (one slice per context; a single context takes the
whole batch), ``clip_global_norm`` (one host sync for the norm) and
``check_sha1``.  ``download`` raises: the port runs without a network.
"""
from __future__ import annotations

import hashlib

from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray along ``batch_axis`` into ``num_slice`` slices
    (reference gluon/utils.py:28)."""
    from .. import ndarray as nd
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d." % (str(data.shape), num_slice,
                                                 batch_axis))
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data." %
            (str(data.shape), num_slice, batch_axis, num_slice))
    step = size // num_slice
    if not even_split:
        slices = [
            nd.slice_axis(data, axis=batch_axis, begin=i * step,
                          end=(i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]
    else:
        slices = [nd.slice_axis(data, axis=batch_axis, begin=i * step,
                                end=(i + 1) * step)
                  for i in range(num_slice)]
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split data along batch_axis and load each slice onto a ctx
    (reference gluon/utils.py:69)."""
    from .. import ndarray as nd
    from ..ndarray import NDArray
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale arrays so that the sum of their 2-norms is at most max_norm
    (reference gluon/utils.py:99)."""
    import math
    if not arrays:
        raise ValueError("arrays must not be empty")
    # reduce on device, one host sync at the end (reference asscalar's once)
    total = (arrays[0] * arrays[0]).sum()
    for arr in arrays[1:]:
        total = total + (arr * arr).sum()
    total_norm = math.sqrt(float(total.asnumpy()))
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    """Check a file against its expected sha1 (reference gluon/utils.py:131)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Reference gluon/utils.py download: raises, with guidance."""
    raise MXNetError(
        "download() is unavailable: the PyTorch port runs without network "
        "access. Place the file at the target path yourself (url=%s)." % url)
