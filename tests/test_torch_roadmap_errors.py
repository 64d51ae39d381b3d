"""PyTorch port: every "not in the port yet" error names the ROADMAP
item that brings it (in the style of
``test_torch_train.py::test_get_symbol_errors_name_their_roadmap_item``)."""
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops.nn import leaky_relu
from mxnet_tpu_torch.ops.registry import get_op

CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)


def _bound_module():
    mod = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 12))],
             label_shapes=[("softmax_label", (48,))])
    mod.init_params()
    return mod


def _leaky(act):
    leaky_relu(torch.zeros(2), act_type=act)


def _compose_symbol_block():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.zeros((1, 3), ctx=mx.cpu()))
    block = mx.gluon.SymbolBlock(net(mx.sym.Variable("data")),
                                 [mx.sym.Variable("data")])
    block(mx.sym.Variable("x"))


# the cases that work now are parity cases elsewhere (inputs_need_grad
# and a batch of another shape: test_torch_module_reshape.py; ftrl:
# test_torch_optimizers_more.py; orthogonal and f1:
# test_torch_train_surface.py); their slots here hold items that wait
@pytest.mark.parametrize("call,item", [
    (lambda: _leaky("elu"), "A.5"),
    (lambda: mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
     .bind(data_shapes=[("data", (4, 12))], shared_module=object()), "A.6"),
    (lambda: mx.gluon.nn.Conv2DTranspose(4, 3), "A.5"),
    (lambda: mx.mod.BucketingModule(), "A.6"),
    (lambda: transformer.get_decode_step_symbol(**CFG, moe_experts=4),
     "A.8"),
    (lambda: transformer.get_mixed_step_symbol(**CFG,
                                               tensor_parallel="mp"),
     "A.8"),
    (lambda: get_op("UpSampling"), "A.6"),
    (lambda: mx.optimizer.create("test"), "A.10"),
    (lambda: mx.initializer.create("lstmbias"), "A.6"),
    (_compose_symbol_block, "A.5"),
], ids=["leaky_relu_act", "shared_module", "deconvolution",
        "bucketing_module", "moe", "tensor_parallel", "op_name",
        "test_optimizer", "lstm_bias", "symbol_block_composition"])
def test_later_slice_errors_name_their_roadmap_item(call, item):
    with pytest.raises(mx.MXNetError) as err:
        call()
    assert "ROADMAP %s" % item in str(err.value)
    assert "(ROADMAP)" not in str(err.value)
