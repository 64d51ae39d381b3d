#!/usr/bin/env python
"""Minimal SSD training (BASELINE config 5) on the PyTorch port (the
port's copy of example/ssd/train_ssd.py).

A small conv body, MultiBoxPrior anchors, MultiBoxTarget-matched
classification (hard negatives mined) and SmoothL1 localization losses,
MultiBoxDetection decoding at evaluation.  The images are generated (a
colored square at a random place on noise), so it runs offline; a
detection RecordIO dataset waits for the port's image iterators (ROADMAP
A.10).  On the card by default::

  python3 example/torch/ssd/train_ssd.py [--ctx cpu] [--num-epochs 12]

It prints the mean IoU of each image's top detection with its object and
the share of top detections of the right class.
"""
import argparse
import logging
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np


def make_dataset(n, size=32, seed=3):
    """Images with one colored square; label rows [cls, x1, y1, x2, y2]."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 3, size, size), np.float32)
    Y = np.zeros((n, 1, 5), np.float32)
    for i in range(n):
        cls = rng.randint(2)            # 0: red square, 1: green square
        w = rng.randint(10, 18)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - w)
        X[i] = rng.rand(3, size, size) * 0.2
        X[i, cls, y0:y0 + w, x0:x0 + w] = 1.0
        Y[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                   (y0 + w) / size]
    return X, Y


def ssd_symbol(num_classes=2):
    from mxnet_tpu_torch import sym

    data = sym.Variable("data")
    label = sym.Variable("label")
    body = data
    for i, nf in enumerate((16, 32, 64)):
        body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=nf, name="conv%d" % i)
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    # feature map 4x4; anchors at 2 scales
    anchors = sym.MultiBoxPrior(body, sizes=(0.4, 0.6), ratios=(1.0,),
                                name="anchors")              # (1, A, 4)
    cls_pred = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=2 * (num_classes + 1),
                               name="cls_pred")
    cls_pred = sym.Reshape(sym.transpose(cls_pred, axes=(0, 2, 3, 1)),
                           shape=(0, -1, num_classes + 1))
    cls_pred = sym.transpose(cls_pred, axes=(0, 2, 1))       # (N, C+1, A)
    loc_pred = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                               num_filter=2 * 4, name="loc_pred")
    loc_pred = sym.Reshape(sym.transpose(loc_pred, axes=(0, 2, 3, 1)),
                           shape=(0, -1))                    # (N, A*4)

    loc_t, loc_mask, cls_t = sym.MultiBoxTarget(
        anchors, label, cls_pred, overlap_threshold=0.5,
        negative_mining_ratio=3.0, ignore_label=-1, name="target")
    cls_loss = sym.SoftmaxOutput(cls_pred, cls_t, multi_output=True,
                                 use_ignore=True, ignore_label=-1,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_mask * (loc_pred - loc_t)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, name="loc_loss")
    det = sym.MultiBoxDetection(cls_loss, loc_pred, anchors,
                                nms_threshold=0.45, name="det")
    return sym.Group([cls_loss, loc_loss, sym.BlockGrad(det)])


def evaluate(dets, Yv):
    """(mean IoU of each image's top detection with its object, share of
    top detections of the object's class); an image with no detection
    counts IoU 0."""
    ious, correct = [], 0
    for det, gt in zip(dets, Yv[:, 0]):
        kept = det[det[:, 0] >= 0]
        if not len(kept):
            ious.append(0.0)
            continue
        best = kept[np.argmax(kept[:, 1])]
        ix1, iy1 = max(best[2], gt[1]), max(best[3], gt[2])
        ix2, iy2 = min(best[4], gt[3]), min(best[5], gt[4])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        a1 = (best[4] - best[2]) * (best[5] - best[3])
        a2 = (gt[3] - gt[1]) * (gt[4] - gt[2])
        ious.append(inter / max(a1 + a2 - inter, 1e-9))
        correct += int(best[0] == gt[0])
    return float(np.mean(ious)), correct / len(Yv)


def main():
    parser = argparse.ArgumentParser(description="minimal SSD")
    parser.add_argument("--num-epochs", type=int, default=12)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--ctx", type=str, default="gpu",
                        choices=("gpu", "cpu"))
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-15s %(message)s")
    import mxnet_tpu_torch as mx

    np.random.seed(args.seed)
    mx.random.seed(args.seed)
    X, Y = make_dataset(192)
    it = mx.io.NDArrayIter({"data": X}, {"label": Y},
                           batch_size=args.batch_size, shuffle=True)
    mod = mx.Module(ssd_symbol(), data_names=("data",),
                    label_names=("label",),
                    context=mx.cpu() if args.ctx == "cpu" else mx.gpu(0))
    mod.fit(it, num_epoch=args.num_epochs, optimizer="adam",
            optimizer_params={"learning_rate": args.lr},
            initializer=mx.init.Xavier(),
            eval_metric=mx.metric.Loss(output_names=["loc_loss_output"]),
            batch_end_callback=mx.callback.Speedometer(args.batch_size, 10))

    # evaluation: decode detections on fresh images
    Xv, Yv = make_dataset(32, seed=99)
    vit = mx.io.NDArrayIter({"data": Xv}, {"label": Yv},
                            batch_size=args.batch_size)
    dets = []
    for batch in vit:
        mod.forward(batch, is_train=False)
        dets.append(mod.get_outputs()[2].asnumpy())
    iou, acc = evaluate(np.concatenate(dets)[:len(Yv)], Yv)
    print("mean IoU of top detection: %.3f; class acc: %.3f" % (iou, acc))
    return iou


if __name__ == "__main__":
    main()
