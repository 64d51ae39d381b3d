"""Data loaders of the image-classification examples, on the PyTorch
port.

The port's copy of ``example/image-classification/common/data.py``: the
data and augmentation argument groups and ``get_rec_iter``, which gives
the synthetic ``--benchmark`` batches (on the training context) when
``--benchmark 1`` or no ``--data-train`` is given.  A RecordIO file needs
``ImageRecordIter``, which waits for the port's ``image/`` and
``recordio`` (ROADMAP A.10).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                ".."))

import mxnet_tpu_torch as mx
from .fit import SyntheticDataIter, devices


def add_data_args(parser):
    data = parser.add_argument_group("Data")
    data.add_argument("--data-train", type=str, default=None,
                      help="training .rec file")
    data.add_argument("--data-train-idx", type=str, default="")
    data.add_argument("--data-val", type=str, default=None)
    data.add_argument("--data-val-idx", type=str, default="")
    data.add_argument("--image-shape", type=str, default="3,224,224")
    data.add_argument("--num-classes", type=int, default=1000)
    data.add_argument("--rgb-mean", type=str, default="123.68,116.779,103.939")
    data.add_argument("--rgb-std", type=str, default="1,1,1")
    data.add_argument("--pad-size", type=int, default=0)
    data.add_argument("--data-nthreads", type=int, default=4)
    return data


def add_data_aug_args(parser):
    aug = parser.add_argument_group("Augmentation")
    aug.add_argument("--random-crop", type=int, default=1)
    aug.add_argument("--random-mirror", type=int, default=1)
    aug.add_argument("--max-random-scale", type=float, default=1.0)
    aug.add_argument("--min-random-scale", type=float, default=1.0)
    aug.add_argument("--brightness", type=float, default=0.0)
    aug.add_argument("--contrast", type=float, default=0.0)
    aug.add_argument("--saturation", type=float, default=0.0)
    aug.add_argument("--pca-noise", type=float, default=0.0)
    aug.add_argument("--random-h", type=int, default=0)
    aug.add_argument("--random-s", type=int, default=0)
    aug.add_argument("--random-l", type=int, default=0)
    return aug


def get_rec_iter(args, kv=None):
    """(reference common/data.py get_rec_iter) the synthetic batches of
    ``--benchmark 1`` (or of no ``--data-train``), channel-last under
    ``--layout NHWC``; no validation iterator."""
    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    chlast = getattr(args, "layout", "NCHW") == "NHWC"
    if getattr(args, "benchmark", 0) or not args.data_train:
        c, h, w = image_shape
        data_shape = (args.batch_size, h, w, c) if chlast \
            else (args.batch_size,) + image_shape
        dev = devices(args)
        train = SyntheticDataIter(args.num_classes, data_shape,
                                  max_iter=max(args.num_examples
                                               // args.batch_size, 1),
                                  dtype=args.dtype,
                                  ctx=dev if isinstance(dev, mx.Context)
                                  else dev[0])
        return train, None
    raise mx.MXNetError("get_rec_iter: --data-train %s needs "
                        "ImageRecordIter, which is not in the PyTorch port "
                        "yet (ROADMAP A.10, image/ and recordio.py); use "
                        "--benchmark 1" % args.data_train)
