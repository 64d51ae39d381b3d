"""PyTorch port: every "not in the port yet" error names the ROADMAP
item that brings it (in the style of
``test_torch_train.py::test_get_symbol_errors_name_their_roadmap_item``)."""
import numpy as np
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


def _lm_sym_gen(seq_len):
    cell = mx.rnn.LSTMCell(8, prefix="lstm_")
    embed = mx.sym.Embedding(mx.sym.Variable("data"), input_dim=10,
                             output_dim=4, name="embed")
    out, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
    pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, 8)),
                                 num_hidden=10, name="pred")
    label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
    return mx.sym.SoftmaxOutput(pred, label, name="softmax"), ("data",), \
        ("softmax_label",)


def _bound_bucketing():
    mod = mx.mod.BucketingModule(_lm_sym_gen, default_bucket_key=6,
                                 context=mx.cpu())
    mod.bind(data_shapes=[("data", (2, 6))],
             label_shapes=[("softmax_label", (2, 6))])
    return mod


# the cases that now work, each checking its new behavior (the RNN slice,
# ROADMAP A.6's RNN item: test_torch_bucketing.py holds them against the
# JAX package)
def _shared_module_binds():
    first = _bound_module()
    second = mx.Module(transformer.get_symbol(**CFG), context=mx.cpu())
    second.bind(data_shapes=[("data", (2, 12))],
                label_shapes=[("softmax_label", (24,))],
                shared_module=first)
    name = "tok_embed_weight"
    assert second._exec_group._exec.arg_dict[name] \
        is first._exec_group._exec.arg_dict[name]


def _bucketing_module_binds_buckets():
    mod = _bound_bucketing()
    mod.init_params()
    mod.switch_bucket(3, [("data", (2, 3))], [("softmax_label", (2, 3))])
    assert sorted(mod.buckets) == [3, 6]


def _lstm_bias_creates():
    init = mx.initializer.create("lstmbias", forget_bias=2.0)
    arr = mx.nd.zeros((8,), ctx=mx.cpu())
    init("x_bias", arr)
    assert arr.asnumpy().tolist() == [0, 0, 2, 2, 0, 0, 0, 0]


def _f16_rnn_graph():
    data = mx.sym.Variable("data")
    out = mx.sym.RNN(data, state_size=4, num_layers=1, mode="gru")
    out.simple_bind(ctx=mx.cpu(), type_dict={"data": "float16"},
                    data=(3, 2, 5))


def _bucketing_monitor():
    _bound_bucketing().install_monitor(object())


# the cases that work now are parity cases elsewhere (inputs_need_grad
# and a batch of another shape: test_torch_module_reshape.py; ftrl:
# test_torch_optimizers_more.py; orthogonal and f1:
# test_torch_train_surface.py; elu and the Conv*Transpose layers:
# test_torch_leaky_relu.py, test_torch_deconvolution.py); their slots
# here hold items that wait.  The RNN slice's three ("works") check
# their new behavior here.  SymbolBlock composition is a limit of the
# JAX package (ROADMAP C): its error names no item.
@pytest.mark.parametrize("call,item", [
    (_dataloader_workers, "A.6"),
    (_shared_module_binds, "works"),
    (_fit_monitor, "A.9"),
    (_bucketing_module_binds_buckets, "works"),
    (lambda: transformer.get_decode_step_symbol(**CFG, moe_experts=4),
     "A.8"),
    (lambda: transformer.get_mixed_step_symbol(**CFG,
                                               tensor_parallel="mp"),
     "A.8"),
    (lambda: get_op("UpSampling"), "A.6"),
    (lambda: mx.optimizer.create("test"), "A.10"),
    (_lstm_bias_creates, "works"),
    (_compose_symbol_block, None),
    (_f16_rnn_graph, "A.6"),
    (_bucketing_monitor, "A.9"),
    (lambda: _bound_module().fit([], num_epoch=1,
                                 sparse_row_id_fn=lambda b: {}), "A.6"),
    (lambda: mx.mod.BucketingModule(_lm_sym_gen, default_bucket_key=6,
                                    state_names=["h"]), "A.6"),
    (lambda: _bound_bucketing().fit(
        mx.io.NDArrayIter(np.ones((2, 6)), np.ones((2, 6)), batch_size=2),
        num_epoch=1, checkpoint_every=2), "A.6"),
], ids=["dataloader_workers", "shared_module", "fit_monitor",
        "bucketing_module", "moe", "tensor_parallel", "op_name",
        "test_optimizer", "lstm_bias", "symbol_block_composition",
        "float16_rnn", "bucketing_monitor", "sparse_row_id_fn",
        "bucketing_state_names", "bucketing_step_checkpoints"])
def test_later_slice_errors_name_their_roadmap_item(call, item):
    if item == "works":
        call()
        return
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
