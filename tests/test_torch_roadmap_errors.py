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


def _forward_other_batch():
    mod = _bound_module()
    mod.forward(mx.io.DataBatch(data=[mx.nd.zeros((2, 12), ctx=mx.cpu())],
                                label=[]))


def _leaky(act):
    leaky_relu(torch.zeros(2), act_type=act)


@pytest.mark.parametrize("call,item", [
    (lambda: _leaky("elu"), "A.5"),
    (lambda: mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
     .bind(data_shapes=[("data", (4, 12))], shared_module=object()), "A.5"),
    (lambda: mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
     .bind(data_shapes=[("data", (4, 12))], inputs_need_grad=True), "A.5"),
    (_forward_other_batch, "A.5"),
    (lambda: transformer.get_decode_step_symbol(**CFG, moe_experts=4),
     "A.8"),
    (lambda: transformer.get_mixed_step_symbol(**CFG,
                                               tensor_parallel="mp"),
     "A.8"),
    (lambda: get_op("UpSampling"), "A.6"),
    (lambda: mx.optimizer.create("ftrl"), "A.5"),
    (lambda: mx.initializer.create("orthogonal"), "A.5"),
    (lambda: mx.metric.create("f1"), "A.5"),
], ids=["leaky_relu_act", "shared_module", "inputs_need_grad", "rebind",
        "moe", "tensor_parallel", "op_name", "optimizer", "initializer",
        "metric"])
def test_later_slice_errors_name_their_roadmap_item(call, item):
    with pytest.raises(mx.MXNetError) as err:
        call()
    assert "ROADMAP %s" % item in str(err.value)
    assert "(ROADMAP)" not in str(err.value)
