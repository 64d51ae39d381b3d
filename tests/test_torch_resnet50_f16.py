"""PyTorch port: bench.py's channel-last ResNet-50 v2 in float16 through
``TrainStep`` (ROADMAP A.1, float16 for rows 7 and 10), unfused and
after ``fuse_conv_bn``, against the JAX package on the CPU at 32x32,
batch 2, 4 classes: the same numpy weights and batch to the port in f16,
the JAX package in f16 (its fused op's Pallas kernel in interpret mode
where a site's rows fill its 128-row tiles) and in f32, held by
tests/test_torch_resnet_f16.py's check for a deep BatchNorm net
(``hold_runs``: each tensor within twice the JAX package's own
f16-to-f32 gap plus 2^-9, outputs and loss within 2^-8 or twice that
package's own f16-to-f32 difference, each f16 weight its master
rounded once), over one step.  At batch 2 the last stages normalize
over 2 to 8 values (stage 4's maps are 1x1), so the gap is large
(gradients 0.4 to 0.7 relative L2) and the net is chaotic: a second
step's outputs move 0.6 relative L2 from the first's even at a
learning rate of 0.005, and land 0.22 from the port's f32 where the
JAX package's land 0.04 from its own f32, while every first-step
tensor holds the check.  The ResNet-50 cases therefore hold the
executor's forward and backward and one TrainStep step (its update);
tests/test_torch_resnet_f16.py's ResNet-18 holds two.  The fused
graph's 28 sites each run row 7's plain f16 form once a forward.
"""
import numpy as np
import pytest

from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.pallas.dispatch import PALLAS_LAUNCHES
from mxnet_tpu.symbol.fuse import fuse_conv_bn as jfuse_conv_bn

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.kernels import LAUNCHES, PLAIN_CALLS, reset_counts
from mxnet_tpu_torch.models import resnet
from mxnet_tpu_torch.symbol.fuse import count_fused, fuse_conv_bn

from test_torch_resnet_f16 import (_env, _few_torch_threads,  # noqa: F401
                                   hold_runs, seeded_weights, symbolic_run)

NET50 = dict(num_classes=4, num_layers=50, image_shape=(3, 32, 32),
             layout="NHWC")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_trainstep_resnet50_nhwc_f16_matches_jax(fused):
    rng = np.random.RandomState(6)
    x = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    batch = {"data": np.ascontiguousarray(x.transpose(0, 2, 3, 1)),
             "softmax_label": rng.randint(0, 4, (2,)).astype(np.float32)}
    shapes = {k: v.shape for k, v in batch.items()}
    args, auxs = seeded_weights(resnet.get_symbol(**NET50), shapes)

    def symbol(pkg, dtype):
        mod, fuse = (resnet, fuse_conv_bn) if pkg is mx \
            else (jresnet, jfuse_conv_bn)
        sym = mod.get_symbol(dtype=dtype, **NET50)
        return fuse(sym) if fused else sym

    counter = PALLAS_LAUNCHES.labels(kernel="fused_scale_relu_matmul")
    runs = {}
    reset_counts()
    runs["port"] = symbolic_run(mx, symbol(mx, "float16"), args, auxs, batch,
                                steps=1)
    # the executor's forward and the step's forward, 28 sites each
    assert PLAIN_CALLS["fused_scale_relu_matmul"] == (2 * 28 if fused else 0)
    assert not any(LAUNCHES.values())
    if fused:
        assert count_fused(symbol(mx, "float16")) == 28
    before = counter.value
    runs["j16"] = symbolic_run(jmx, symbol(jmx, "float16"), args, auxs,
                               batch, steps=1)
    assert (counter.value > before) == fused
    runs["j32"] = symbolic_run(jmx, symbol(jmx, "float32"), args, auxs,
                               batch, steps=1)
    assert "conv0_weight" in runs["port"]["low"]
    hold_runs("resnet50_nhwc" + ("_fused" if fused else ""), runs["port"],
              runs["j16"], runs["j32"], args, batch["softmax_label"])
