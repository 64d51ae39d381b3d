#!/usr/bin/env python
"""Train ImageNet-scale image classifiers on the PyTorch port (the
port's copy of example/image-classification/train_imagenet.py)::

  python3 example/torch/image-classification/train_imagenet.py \\
      --network resnet --num-layers 50 --benchmark 1 \\
      [--layout NHWC] [--dtype bfloat16] [--ctx cpu]

``--benchmark 1`` trains on synthetic batches kept on the card; a
RecordIO ``--data-train`` waits for the port's ``ImageRecordIter``
(ROADMAP A.10).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import data as _data
from common import fit as _fit

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models


def main():
    parser = argparse.ArgumentParser(
        description="train imagenet-scale classifiers",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    _fit.add_fit_args(parser)
    _data.add_data_args(parser)
    _data.add_data_aug_args(parser)
    parser.add_argument("--layout", type=str, default="NCHW",
                        choices=["NCHW", "NHWC"],
                        help="NHWC = channel-last end to end (resnet "
                             "only)")
    parser.set_defaults(network="resnet", num_layers=50,
                        image_shape="3,224,224", num_classes=1000,
                        num_epochs=80, lr_step_epochs="30,60,90",
                        lr=0.1, batch_size=128)
    args = parser.parse_args()

    image_shape = tuple(int(x) for x in args.image_shape.split(","))
    kwargs = {}
    if args.layout != "NCHW":
        if args.network != "resnet":
            raise SystemExit("--layout NHWC is supported by the resnet "
                             "builder only")
        kwargs["layout"] = args.layout
    net = models.get_symbol(args.network, num_classes=args.num_classes,
                            num_layers=args.num_layers,
                            image_shape=image_shape, dtype=args.dtype,
                            **kwargs)
    mx.random.seed(7)
    _fit.fit(args, net, _data.get_rec_iter)


if __name__ == "__main__":
    main()
