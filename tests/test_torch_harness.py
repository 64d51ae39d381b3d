"""PyTorch port: the image-classification and DCGAN harnesses and what
they need.

``mx.io.MNISTIter`` on tiny idx files written to ``tmp_path`` gives the
JAX package's batches (in order, and shuffled from one seed); the
``mlp`` symbol is the JAX package's (arguments, shapes, outputs on the
same weights); each port harness under ``example/torch/`` runs end to
end on ``--ctx cpu`` at a tiny size, in a process of its own with a time
limit, and ends with finite losses; and one step of the DCGAN module
pair (Deconvolution, LeakyReLU, ``inputs_need_grad``, the input gradient
fed back into the generator) ends on the JAX package's G and D weights
at 2e-5 / 1e-6.
"""
import importlib.util
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(ROOT, "example", "torch")


def _write_idx(path, arr):
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def _mnist_files(tmp_path, n_train=80, n_test=40, seed=0):
    rng = np.random.RandomState(seed)
    files = {}
    for stem, n in (("train", n_train), ("t10k", n_test)):
        img = rng.randint(0, 256, (n, 28, 28))
        lab = rng.randint(0, 10, (n,))
        files[stem + "-images-idx3-ubyte"] = img
        files[stem + "-labels-idx1-ubyte"] = lab
    for name, arr in files.items():
        _write_idx(str(tmp_path / name), arr)
    return files


def _batches(it):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
    return out


@pytest.mark.parametrize("flat,shuffle", [(False, False), (True, False),
                                          (False, True)])
def test_mnist_iter_gives_the_jax_batches(tmp_path, flat, shuffle):
    files = _mnist_files(tmp_path)
    kw = dict(image=str(tmp_path / "train-images-idx3-ubyte"),
              label=str(tmp_path / "train-labels-idx1-ubyte"),
              batch_size=32, flat=flat, shuffle=shuffle)
    mx.random.seed(5)
    got = _batches(mx.io.MNISTIter(**kw))
    np.random.seed(5)
    want = _batches(jmx.io.MNISTIter(**kw))
    assert len(got) == len(want) == 2       # 80 // 32, the rest dropped
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    x0 = got[0][0]
    assert x0.shape == ((32, 784) if flat else (32, 1, 28, 28))
    if not shuffle:
        img = files["train-images-idx3-ubyte"][:32].astype(np.float32) / 255
        np.testing.assert_array_equal(x0.reshape(32, 28, 28), img)


def test_mnist_iter_reads_gzip_and_refuses_a_missing_file(tmp_path):
    import gzip
    _mnist_files(tmp_path)
    for stem in ("images-idx3", "labels-idx1"):
        raw = (tmp_path / ("train-%s-ubyte" % stem)).read_bytes()
        with gzip.open(str(tmp_path / ("train-%s-ubyte.gz" % stem)),
                       "wb") as f:
            f.write(raw)
    a = _batches(mx.io.MNISTIter(
        image=str(tmp_path / "train-images-idx3-ubyte.gz"),
        label=str(tmp_path / "train-labels-idx1-ubyte.gz"), batch_size=16,
        shuffle=False))
    b = _batches(mx.io.MNISTIter(
        image=str(tmp_path / "train-images-idx3-ubyte"),
        label=str(tmp_path / "train-labels-idx1-ubyte"), batch_size=16,
        shuffle=False))
    assert len(a) == 5
    for (ax, ay), (bx, by) in zip(a, b):
        np.testing.assert_array_equal(ax, bx)
        np.testing.assert_array_equal(ay, by)
    with pytest.raises(mx.MXNetError):
        mx.io.MNISTIter(image=str(tmp_path / "nope"), label="nope")


def test_mlp_is_the_jax_symbol():
    got, want = models.get_symbol("mlp"), jmodels.get_symbol("mlp")
    assert got.list_arguments() == want.list_arguments()
    assert got.list_outputs() == want.list_outputs()
    shapes = dict(data=(4, 1, 28, 28), softmax_label=(4,))
    ga, go, _ = got.infer_shape(**shapes)
    wa, wo, _ = want.infer_shape(**shapes)
    assert [tuple(s) for s in ga] == [tuple(s) for s in wa]
    assert [tuple(s) for s in go] == [tuple(s) for s in wo]
    rng = np.random.RandomState(3)
    vals = {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in zip(got.list_arguments(), ga)}
    exe = got.simple_bind(ctx=mx.cpu(), **shapes)
    exe.copy_params_from(vals)
    jexe = want.simple_bind(ctx=jmx.cpu(), **shapes)
    jexe.copy_params_from({k: jmx.nd.array(v) for k, v in vals.items()})
    np.testing.assert_allclose(exe.forward()[0].asnumpy(),
                               jexe.forward()[0].asnumpy(), rtol=2e-5,
                               atol=1e-6)


def _run(args, timeout=240):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    return proc.stdout + proc.stderr


def _final(out):
    line = [ln for ln in out.splitlines() if "final train metrics" in ln][-1]
    assert line.endswith("finite True"), line
    return line


IC = os.path.join(HARNESS, "image-classification")


@pytest.mark.parametrize("network", ["mlp", "lenet"])
def test_train_mnist_runs_on_the_cpu(tmp_path, network):
    """Synthetic digits (no idx files), one epoch."""
    out = _run([os.path.join(IC, "train_mnist.py"), "--ctx", "cpu",
                "--network", network, "--num-epochs", "1",
                "--num-examples", "256", "--disp-batches", "2",
                "--data-dir", str(tmp_path / "none")])
    assert "synthetic digits" in out
    assert "samples/sec" in out
    _final(out)


def test_train_mnist_reads_idx_files(tmp_path):
    _mnist_files(tmp_path, n_train=128, n_test=64)
    out = _run([os.path.join(IC, "train_mnist.py"), "--ctx", "cpu",
                "--num-epochs", "1", "--data-dir", str(tmp_path)])
    assert "synthetic digits" not in out
    _final(out)


@pytest.mark.parametrize("layout,dtype", [("NCHW", "float32"),
                                          ("NHWC", "bfloat16")])
def test_train_imagenet_benchmark_runs_on_the_cpu(layout, dtype):
    out = _run([os.path.join(IC, "train_imagenet.py"), "--ctx", "cpu",
                "--benchmark", "1", "--num-layers", "18", "--image-shape",
                "3,32,32", "--num-classes", "10", "--batch-size", "4",
                "--num-examples", "12", "--num-epochs", "1",
                "--disp-batches", "1", "--layout", layout, "--dtype", dtype])
    assert "samples/sec" in out
    _final(out)


def test_train_imagenet_vgg_runs_on_the_cpu():
    """``--network vgg`` (models.vgg, the classifier with Dropout) on
    synthetic data for one batch at a small image shape."""
    out = _run([os.path.join(IC, "train_imagenet.py"), "--ctx", "cpu",
                "--network", "vgg", "--num-layers", "11", "--benchmark", "1",
                "--image-shape", "3,32,32", "--num-classes", "10",
                "--batch-size", "2", "--num-examples", "2", "--num-epochs",
                "1", "--disp-batches", "1"])
    _final(out)


def test_train_imagenet_refuses_a_record_file():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(IC, "train_imagenet.py"), "--ctx",
         "cpu", "--data-train", "train.rec", "--num-layers", "18"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode != 0
    assert "ROADMAP A.10" in proc.stderr


def test_dcgan_runs_on_the_cpu():
    out = _run([os.path.join(HARNESS, "gan", "dcgan.py"), "--ctx", "cpu",
                "--num-iter", "25", "--batch-size", "16"])
    assert "dcgan example OK" in out


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair_params(sym, shapes, seed):
    """Weights drawn from ``seed`` (gammas near 1), BatchNorm's moving
    statistics at their start."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, auxs = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n not in shapes:
            a = rng.randn(*s) * 0.05
            args[n] = (a + 1 if n.endswith("_gamma") else a).astype(
                np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        auxs[n] = (np.ones(s) if n.endswith("var") else np.zeros(s)).astype(
            np.float32)
    return args, auxs


def test_dcgan_step_matches_the_jax_package():
    """One iteration of the module pair on the same weights, codes and
    real images: G's and D's weights and G's moving statistics end on
    the JAX package's.  SGD with momentum, whose move is linear in the
    gradients, so the weights hold the gradients at the f32 bound (the
    harness's Adam divides a gradient at rounding level by its own root
    square, which magnifies the packages' rounding differences there
    into visible moves)."""
    port = _load(os.path.join(HARNESS, "gan", "dcgan.py"), "port_dcgan")
    ref = _load(os.path.join(ROOT, "example", "gan", "dcgan.py"),
                "jax_dcgan")
    B, code_dim, lr = 8, 16, 0.02
    rng = np.random.RandomState(0)
    code = rng.randn(B, code_dim).astype(np.float32)
    real = ref.real_batch(rng, B)

    params = {"G": _pair_params(port.make_generator(code_dim=code_dim),
                                {"code": (B, code_dim)}, 7),
              "D": _pair_params(port.make_discriminator(),
                                {"data": (B, 1, 16, 16), "label": (B,)}, 8)}
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
    modG, modD = port.bind_pair(mx, B, code_dim, lr, mx.cpu(), "sgd", opt)
    for name, m in (("G", modG), ("D", modD)):
        args, auxs = params[name]
        m.set_params({k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                      args.items()},
                     {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                      auxs.items()})
    port.train_step(mx, modG, modD, mx.nd.array(code, ctx=mx.cpu()),
                    mx.nd.array(real, ctx=mx.cpu()),
                    mx.nd.ones((B,), ctx=mx.cpu()),
                    mx.nd.zeros((B,), ctx=mx.cpu()))

    jG = jmx.Module(ref.make_generator(code_dim=code_dim),
                    data_names=["code"], label_names=[], context=jmx.cpu())
    jG.bind(data_shapes=[("code", (B, code_dim))])
    jD = jmx.Module(ref.make_discriminator(), data_names=["data"],
                    label_names=["label"], context=jmx.cpu())
    jD.bind(data_shapes=[("data", (B, 1, 16, 16))],
            label_shapes=[("label", (B,))], inputs_need_grad=True)
    for name, m in (("G", jG), ("D", jD)):
        args, auxs = params[name]
        m.init_params(arg_params={k: jmx.nd.array(v) for k, v in
                                  args.items()},
                      aux_params={k: jmx.nd.array(v) for k, v in
                                  auxs.items()})
        m.init_optimizer(optimizer="sgd", optimizer_params=opt)
    DataBatch = jmx.io.DataBatch
    ones, zeros = jmx.nd.ones((B,)), jmx.nd.zeros((B,))
    jG.forward(DataBatch([jmx.nd.array(code)], []), is_train=True)
    fake = jG.get_outputs()[0]
    jD.forward(DataBatch([fake], [zeros]), is_train=True)
    jD.backward()
    jD.update()
    jD.forward(DataBatch([jmx.nd.array(real)], [ones]), is_train=True)
    jD.backward()
    jD.update()
    jD.forward(DataBatch([fake], [ones]), is_train=True)
    jD.backward()
    jG.backward([jD.get_input_grads()[0]])
    jG.update()

    for m, jm in ((modG, jG), (modD, jD)):
        (args, auxs), (jargs, jauxs) = m.get_params(), jm.get_params()
        for got, want in ((args, jargs), (auxs, jauxs)):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k].asnumpy(),
                                           want[k].asnumpy(), rtol=2e-5,
                                           atol=1e-6, err_msg=k)


RNN = os.path.join(HARNESS, "rnn")


@pytest.mark.parametrize("extra", [[], ["--gc-type", "2bit"], ["--fused"]],
                         ids=["cells", "2bit", "fused"])
def test_lstm_bucketing_runs_on_the_cpu(extra):
    """The bucketing LM at a tiny width on a drawn corpus, one epoch:
    the step cells, with 2-bit compression, and the fused RNN op."""
    out = _run([os.path.join(RNN, "lstm_bucketing.py"), "--ctx", "cpu",
                "--num-sentences", "200", "--num-epochs", "1",
                "--num-hidden", "16", "--num-embed", "8", "--vocab-size",
                "50", "--batch-size", "8", "--buckets", "5,10,20,40",
                "--disp-batches", "5"] + extra)
    assert "samples/sec" in out and "tokens/s" in out
    assert "vocab 51" in out
    _final(out)


def test_char_lm_runs_on_the_cpu():
    """The character LM on the committed fixture at a tiny width, one
    epoch (its perplexity target set out of the way)."""
    out = _run([os.path.join(RNN, "char_lm.py"), "--ctx", "cpu",
                "--num-epochs", "1", "--num-hidden", "16",
                "--target-ppl", "1000"])
    assert "final train perplexity" in out and "char_lm OK" in out


def test_ssd_harness_reaches_its_iou():
    """example/torch/ssd/train_ssd.py for 6 epochs: the mean IoU of each
    image's top detection passes ``chip_smoke.SSD_HARNESS_IOU`` (the
    card's harness holds the same bound at its 12)."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    out = _run([os.path.join(HARNESS, "ssd", "train_ssd.py"), "--ctx", "cpu",
                "--num-epochs", "6"])
    line = [ln for ln in out.splitlines()
            if ln.startswith("mean IoU of top detection")][-1]
    iou = float(line.split(":")[1].split(";")[0])
    assert iou > chip_smoke.SSD_HARNESS_IOU, line
    assert "Speed:" in out
