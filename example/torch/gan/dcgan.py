#!/usr/bin/env python
"""DCGAN on synthetic images, on the PyTorch port (the port's copy of
example/gan/dcgan.py).

Generator: FC -> reshape -> two Deconvolution upsamplings to 16x16.
Discriminator: two Convolutions with LeakyReLU (slope 0.2) -> FC ->
logistic.  Trained adversarially through two Modules sharing one
minibatch a step, the reference's module-pair flow: modG forward, modD
forward and backward on fake and on real, then modG backward with
modD's input gradient (``inputs_need_grad``).

The "real" images are bright squares on a dark field; the run succeeds
when both losses stay finite, the generator leaves its start and the
discriminator does not win outright.  On the card by default::

  python3 example/torch/gan/dcgan.py [--ctx cpu] [--num-iter 120]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))

import numpy as np


def make_generator(ngf=16, code_dim=16):
    from mxnet_tpu_torch import sym

    code = sym.Variable("code")                       # (B, code_dim)
    g = sym.FullyConnected(code, num_hidden=ngf * 2 * 4 * 4, name="g_fc")
    g = sym.Activation(g, act_type="relu")
    g = sym.Reshape(g, shape=(-1, ngf * 2, 4, 4), name="g_reshape")
    g = sym.Deconvolution(g, kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                          num_filter=ngf, name="g_deconv1")   # 8x8
    g = sym.BatchNorm(g, fix_gamma=False, name="g_bn1")
    g = sym.Activation(g, act_type="relu")
    g = sym.Deconvolution(g, kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                          num_filter=1, name="g_deconv2")     # 16x16
    return sym.Activation(g, act_type="sigmoid", name="g_out")


def make_discriminator(ndf=16):
    from mxnet_tpu_torch import sym

    data = sym.Variable("data")                       # (B, 1, 16, 16)
    d = sym.Convolution(data, kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                        num_filter=ndf, name="d_conv1")
    d = sym.LeakyReLU(d, act_type="leaky", slope=0.2)
    d = sym.Convolution(d, kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                        num_filter=ndf * 2, name="d_conv2")
    d = sym.LeakyReLU(d, act_type="leaky", slope=0.2)
    d = sym.FullyConnected(sym.Flatten(d), num_hidden=1, name="d_fc")
    label = sym.Variable("label")
    return sym.LogisticRegressionOutput(d, label, name="dloss")


def real_batch(rng, batch):
    """Bright 6x6..10x10 squares centered-ish on a dark field."""
    x = rng.rand(batch, 1, 16, 16).astype("float32") * 0.1
    for i in range(batch):
        s = rng.randint(3, 6)
        cy, cx = rng.randint(4, 12, 2)
        x[i, 0, max(0, cy - s):cy + s, max(0, cx - s):cx + s] = \
            0.8 + 0.2 * rng.rand()
    return x


def bind_pair(mx, batch, code_dim, lr, ctx, optimizer="adam",
              optimizer_params=None):
    """modG and modD bound on ``ctx``, Normal(0.05) weights, Adam with
    beta1 0.5 (the reference's settings) unless ``optimizer`` and
    ``optimizer_params`` say otherwise."""
    params = optimizer_params or {"learning_rate": lr, "beta1": 0.5}
    modG = mx.Module(make_generator(code_dim=code_dim), data_names=["code"],
                     label_names=[], context=ctx)
    modG.bind(data_shapes=[("code", (batch, code_dim))])
    modG.init_params(mx.initializer.Normal(0.05))
    modG.init_optimizer(optimizer=optimizer, optimizer_params=params)
    modD = mx.Module(make_discriminator(), data_names=["data"],
                     label_names=["label"], context=ctx)
    modD.bind(data_shapes=[("data", (batch, 1, 16, 16))],
              label_shapes=[("label", (batch,))], inputs_need_grad=True)
    modD.init_params(mx.initializer.Normal(0.05))
    modD.init_optimizer(optimizer=optimizer, optimizer_params=params)
    return modG, modD


def train_step(mx, modG, modD, code, real, ones, zeros):
    """One iteration of the pair: D on fake (label 0) and on real (label
    1), then G through D's input gradient on fake labelled 1.  Returns
    (fake, D's outputs on fake, D's outputs on real), as NDArrays."""
    DataBatch = mx.io.DataBatch
    modG.forward(DataBatch([code], []), is_train=True)
    fake = modG.get_outputs()[0]
    modD.forward(DataBatch([fake], [zeros]), is_train=True)
    out_fake = modD.get_outputs()[0].copy()
    modD.backward()
    modD.update()
    modD.forward(DataBatch([real], [ones]), is_train=True)
    out_real = modD.get_outputs()[0].copy()
    modD.backward()
    modD.update()
    modD.forward(DataBatch([fake], [ones]), is_train=True)
    modD.backward()
    modG.backward([modD.get_input_grads()[0]])
    modG.update()
    return fake, out_fake, out_real


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-iter", type=int, default=120)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--code-dim", type=int, default=16)
    ap.add_argument("--ctx", type=str, default="gpu", choices=["gpu", "cpu"])
    args = ap.parse_args()

    import mxnet_tpu_torch as mx

    np.random.seed(11)
    mx.random.seed(11)
    ctx = mx.gpu(0) if args.ctx == "gpu" else mx.cpu()
    B = args.batch_size
    modG, modD = bind_pair(mx, B, args.code_dim, args.lr, ctx)
    rng = np.random.RandomState(0)
    ones = mx.nd.ones((B,), ctx=ctx)
    zeros = mx.nd.zeros((B,), ctx=ctx)

    def d_acc(out, want_real):
        p = out.asnumpy().reshape(-1)
        return float(((p > 0.5) == want_real).mean())

    def loss(out, want_real):
        p = np.clip(out.asnumpy().reshape(-1).astype(np.float64), 1e-12,
                    1 - 1e-12)
        return float(-np.mean(np.log(p if want_real else 1 - p)))

    accs = []
    for it in range(args.num_iter):
        code = mx.nd.array(rng.randn(B, args.code_dim).astype("float32"),
                           ctx=ctx)
        real = mx.nd.array(real_batch(rng, B), ctx=ctx)
        fake, out_fake, out_real = train_step(mx, modG, modD, code, real,
                                              ones, zeros)
        accs.append((d_acc(out_fake, False) + d_acc(out_real, True)) / 2)
        if it % 20 == 0 or it == args.num_iter - 1:
            fk = fake.asnumpy()
            d_loss = loss(out_fake, False) + loss(out_real, True)
            g_loss = loss(out_fake, True)
            print("iter %3d: D acc %.2f, D loss %.4f, G loss %.4f, fake mean "
                  "%.3f std %.3f" % (it, accs[-1], d_loss, g_loss, fk.mean(),
                                      fk.std()))
            if not (np.isfinite(d_loss) and np.isfinite(g_loss)):
                raise SystemExit("dcgan: a loss is not finite")

    fake_np = fake.asnumpy()
    assert np.isfinite(fake_np).all()
    # the generator must have moved off its start (near-uniform 0.5) and
    # make contrast; the discriminator must not win outright
    assert fake_np.std() > 0.05, fake_np.std()
    tail_acc = float(np.mean(accs[-20:]))
    assert tail_acc < 0.995, tail_acc
    print("dcgan example OK (tail D acc %.3f)" % tail_acc)


if __name__ == "__main__":
    main()
