"""PyTorch port: every "not in the port yet" error names the ROADMAP
item that brings it (in the style of
``test_torch_train.py::test_get_symbol_errors_name_their_roadmap_item``)."""
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer
from mxnet_tpu_torch.ops.registry import get_op

CFG = dict(num_classes=61, num_layers=2, d_model=32, num_heads=4, seq_len=12)


def _bound_module():
    mod = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
    mod.bind(data_shapes=[("data", (4, 12))],
             label_shapes=[("softmax_label", (48,))])
    mod.init_params()
    return mod


def _dataloader_workers():
    mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(torch.zeros(4, 2)),
                             batch_size=2, num_workers=2)


def _fit_monitor():
    _bound_module().fit([], num_epoch=1, monitor=object())


def _symbol_block():
    net = mx.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.zeros((1, 3), ctx=mx.cpu()))
    return mx.gluon.SymbolBlock(net(mx.sym.Variable("data")),
                                [mx.sym.Variable("data")],
                                params=net.collect_params())


def _compose_symbol_block():
    _symbol_block()(mx.sym.Variable("x"))


# the cases that work now are parity cases elsewhere (inputs_need_grad
# and a batch of another shape: test_torch_module_reshape.py; ftrl:
# test_torch_optimizers_more.py; orthogonal and f1:
# test_torch_train_surface.py; elu and the Conv*Transpose layers:
# test_torch_leaky_relu.py, test_torch_deconvolution.py); their slots
# here hold items that wait.  SymbolBlock composition is a limit of the
# JAX package (ROADMAP C): its error names no item.
@pytest.mark.parametrize("call,item", [
    (_dataloader_workers, "A.6"),
    (lambda: mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
     .bind(data_shapes=[("data", (4, 12))], shared_module=object()), "A.6"),
    (_fit_monitor, "A.9"),
    (lambda: mx.mod.BucketingModule(), "A.6"),
    (lambda: transformer.get_decode_step_symbol(**CFG, moe_experts=4),
     "A.8"),
    (lambda: transformer.get_mixed_step_symbol(**CFG,
                                               tensor_parallel="mp"),
     "A.8"),
    (lambda: get_op("UpSampling"), "A.6"),
    (lambda: mx.optimizer.create("test"), "A.10"),
    (lambda: mx.initializer.create("lstmbias"), "A.6"),
    (_compose_symbol_block, None),
], ids=["dataloader_workers", "shared_module", "fit_monitor",
        "bucketing_module", "moe", "tensor_parallel", "op_name",
        "test_optimizer", "lstm_bias", "symbol_block_composition"])
def test_later_slice_errors_name_their_roadmap_item(call, item):
    with pytest.raises(mx.MXNetError) as err:
        call()
    if item is None:
        # a limit of the JAX package, not a later slice
        assert "ROADMAP" not in str(err.value)
        assert "as in the JAX package" in str(err.value)
    else:
        assert "ROADMAP %s" % item in str(err.value)
    assert "(ROADMAP)" not in str(err.value)


class _Holder(mx.gluon.HybridBlock):
    def __init__(self, inner, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.inner = inner

    def hybrid_forward(self, F, x):
        return self.inner(x) * 2


@pytest.mark.parametrize("how", ["hybridized", "export"])
def test_a_block_holding_a_symbol_block_runs_eagerly_only(how, tmp_path):
    """As in the JAX package: a block that holds a SymbolBlock runs
    eagerly, and raises once hybridized or exported (its traced graph
    would call the SymbolBlock on a Symbol); the error names no ROADMAP
    item."""
    block = _Holder(_symbol_block())
    x = mx.nd.ones((1, 3), ctx=mx.cpu())
    eager = block(x).asnumpy()
    assert eager.shape == (1, 2)
    block.hybridize()
    with pytest.raises(mx.MXNetError) as err:
        block(x) if how == "hybridized" else block.export(
            str(tmp_path / "held"))
    assert "cannot be composed" in str(err.value)
    assert "ROADMAP" not in str(err.value)
