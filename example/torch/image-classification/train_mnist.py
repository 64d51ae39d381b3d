#!/usr/bin/env python
"""Train MNIST classifiers on the PyTorch port (the port's copy of
example/image-classification/train_mnist.py).

Reads ``mx.io.MNISTIter`` batches when the four idx files are under
``--data-dir``; without them it trains on generated digit prototypes,
as the reference script does.  On the card by default; ``--ctx cpu``
trains on the CPU::

  python3 example/torch/image-classification/train_mnist.py \\
      --network mlp --num-epochs 1 [--ctx cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from common import fit as _fit

import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models


def _synthetic_mnist(n=2000, seed=7):
    rng = np.random.RandomState(seed)
    protos = (rng.rand(10, 28, 28) > 0.65).astype(np.float32)
    X = np.zeros((n, 1, 28, 28), np.float32)
    y = np.zeros((n,), np.float32)
    for i in range(n):
        c = rng.randint(10)
        img = np.roll(np.roll(protos[c], rng.randint(-2, 3), 0),
                      rng.randint(-2, 3), 1)
        X[i, 0] = img + rng.randn(28, 28) * 0.25
        y[i] = c
    return X, y


def get_mnist_iter(args, kv):
    files = ["train-images-idx3-ubyte", "train-labels-idx1-ubyte",
             "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"]
    have = args.data_dir and all(
        os.path.exists(os.path.join(args.data_dir, f)) for f in files)
    if have:
        train = mx.io.MNISTIter(
            image=os.path.join(args.data_dir, files[0]),
            label=os.path.join(args.data_dir, files[1]),
            batch_size=args.batch_size, shuffle=True, flat=False)
        val = mx.io.MNISTIter(
            image=os.path.join(args.data_dir, files[2]),
            label=os.path.join(args.data_dir, files[3]),
            batch_size=args.batch_size, flat=False)
        return train, val
    print("MNIST files not found under %r: training on synthetic digits"
          % (args.data_dir,))
    X, y = _synthetic_mnist(args.num_examples + args.num_examples // 9)
    cut = args.num_examples
    train = mx.io.NDArrayIter(X[:cut], y[:cut], args.batch_size,
                              shuffle=True)
    val = mx.io.NDArrayIter(X[cut:], y[cut:], args.batch_size)
    return train, val


def main():
    parser = argparse.ArgumentParser(
        description="train mnist",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("--data-dir", type=str, default="mnist_data")
    parser.add_argument("--num-classes", type=int, default=10)
    _fit.add_fit_args(parser)
    parser.set_defaults(network="mlp", num_layers=0, num_epochs=10,
                        batch_size=64, lr=0.05, lr_step_epochs="10",
                        optimizer="sgd", num_examples=1800,
                        kv_store="local")
    args = parser.parse_args()

    if args.network == "mlp":
        net = models.get_symbol("mlp", num_classes=args.num_classes)
    else:
        net = models.get_symbol(args.network,
                                num_classes=args.num_classes,
                                num_layers=args.num_layers,
                                image_shape=(1, 28, 28), dtype=args.dtype)
    mx.random.seed(7)
    np.random.seed(7)
    _fit.fit(args, net, get_mnist_iter)


if __name__ == "__main__":
    main()
