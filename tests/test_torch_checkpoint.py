"""The port's files against the JAX package's (ROADMAP A.7).

NDArray files (``nd.save``/``nd.load``), symbol JSON, the reference's
convnet fixture, ``Module.save_checkpoint``/``Module.load`` with
optimizer states, and the Gluon files (``save_parameters``, ``export``
+ ``SymbolBlock.imports``, ``Trainer.save_states``): each written by one
package and read by the other, at small sizes on the CPU.  The JAX
package runs as its own tests run it.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.base import NameManager as JNameManager
from mxnet_tpu.models import lenet as jlenet
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.models import transformer as jtransformer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import pickle_compat
from mxnet_tpu_torch.base import NameManager
from mxnet_tpu_torch.models import lenet, resnet, transformer

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
PKGS = {"jax": jmx, "port": mx}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _nd(pkg, a, dtype=None):
    x = jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())
    return x if dtype is None else x.astype(dtype)


def _host(x):
    """An array of either package (or numpy, or a tensor) as numpy; bf16
    as float32, which holds it exactly."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "_data") and isinstance(getattr(x, "_data"),
                                          torch.Tensor):
        return _host(x._data)
    a = np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype_name(x):
    if hasattr(x, "_data") and isinstance(x._data, torch.Tensor):
        return str(x._data.dtype).replace("torch.", "")
    return np.dtype(x.dtype).name


# ----------------------------------------------------------------------
# NDArray files
# ----------------------------------------------------------------------
_ARRAYS = {"f32": np.float32, "f16": np.float16, "u8": np.uint8,
           "i32": np.int32}


def _nd_dict(pkg, with_bf16):
    rng = np.random.RandomState(0)
    out = {}
    for k, dt in _ARRAYS.items():
        a = (rng.randn(3, 4) * 50).astype(dt)
        out[k] = jmx.nd.array(a, dtype=a.dtype) if pkg is jmx \
            else _nd(pkg, a)
    out["scalar"] = _nd(pkg, np.float32([2.5]))
    if with_bf16:
        out["bf16"] = _nd(pkg, rng.randn(5, 2).astype(np.float32),
                          "bfloat16")
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("with_bf16", [False, True], ids=["binary", "npz"])
def test_nd_save_files_identical_and_read_by_the_other(tmp_path, writer,
                                                       reader, with_bf16):
    """Both packages write the same bytes for the same dict (the
    reference binary; with a bf16 array, the npz container, whose
    members are compared since the zip stamps the time), and each reads
    the other's file: same keys, types and values."""
    files = {}
    for name, pkg in PKGS.items():
        files[name] = str(tmp_path / ("%s.nd" % name))
        pkg.nd.save(files[name], _nd_dict(pkg, with_bf16))
    blobs = {n: open(f, "rb").read() for n, f in files.items()}
    if with_bf16:
        members = {}
        for n, f in files.items():
            with np.load(f) as z:
                members[n] = {k: z[k].tobytes() + str(z[k].dtype).encode()
                              for k in z.files}
        assert members["jax"] == members["port"]
        assert any(k.startswith("__bf16__") for k in members["port"])
    else:
        assert blobs["jax"] == blobs["port"]
    got = PKGS[reader].nd.load(files[writer])
    want = _nd_dict(PKGS[writer], with_bf16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert _dtype_name(got[k]) == _dtype_name(want[k]), k
        np.testing.assert_array_equal(_host(got[k]), _host(want[k]))
    # float64: the JAX package holds no f64 array (JAX runs without
    # x64), so the port's f64 file is read there as its f32 values
    f64 = np.random.RandomState(1).randn(2, 3)
    mx.nd.save(files["port"], {"f64": mx.nd.array(f64, ctx=mx.cpu(),
                                                  dtype="float64")})
    back = mx.nd.load(files["port"])["f64"]
    assert back.dtype == torch.float64
    np.testing.assert_array_equal(_host(back), f64)
    np.testing.assert_array_equal(
        _host(jmx.nd.load(files["port"])["f64"]), f64.astype(np.float32))
    # a list and load_frombuffer
    lst = [_nd(PKGS[writer], np.arange(4, dtype=np.float32))]
    PKGS[writer].nd.save(files[writer], lst)
    back = mx.nd.load_frombuffer(open(files[writer], "rb").read()) \
        if reader == "port" else jmx.nd.load(files[writer])
    assert isinstance(back, list) and len(back) == 1
    np.testing.assert_array_equal(_host(back[0]), np.arange(4))


def test_nd_load_legacy_layouts_and_refuses_sparse(tmp_path):
    """The pre-V2 fixture the JAX package's interop test reads, and a
    row-sparse file that waits for ROADMAP A.6."""
    got = mx.nd.load(os.path.join(FIX, "ref_legacy.params"))
    want = jmx.nd.load(os.path.join(FIX, "ref_legacy.params"))
    assert sorted(got) == sorted(want) if isinstance(want, dict) \
        else len(got) == len(want)
    items = got.items() if isinstance(got, dict) else enumerate(got)
    for k, v in items:
        np.testing.assert_array_equal(_host(v), _host(want[k]))
    sp = jmx.nd.sparse.row_sparse_array(
        (np.ones((1, 3), np.float32), np.array([1])), shape=(4, 3))
    jmx.nd.save(str(tmp_path / "sp.nd"), {"s": sp})
    with pytest.raises(mx.MXNetError, match="A.6"):
        mx.nd.load(str(tmp_path / "sp.nd"))


# ----------------------------------------------------------------------
# symbol JSON
# ----------------------------------------------------------------------
_TCFG = dict(num_classes=64, num_layers=2, d_model=32, num_heads=4,
             ffn_dim=64, seq_len=16)


def _mlp(pkg):
    s = pkg.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=16, name="fc1")
    h = s.Activation(h, act_type="relu", name="relu1")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=4, name="fc2"),
                           name="softmax")


_SYMBOLS = {
    "transformer": (lambda: jtransformer.get_symbol(**_TCFG),
                    lambda: transformer.get_symbol(**_TCFG)),
    "transformer_bf16": (
        lambda: jtransformer.get_symbol(dtype="bfloat16", **_TCFG),
        lambda: transformer.get_symbol(dtype="bfloat16", **_TCFG)),
    "resnet50_v2": (
        lambda: jresnet.get_symbol(num_classes=10, num_layers=50,
                                   image_shape=(3, 32, 32)),
        lambda: resnet.get_symbol(num_classes=10, num_layers=50,
                                  image_shape=(3, 32, 32))),
    "lenet": (lambda: jlenet.get_symbol(num_classes=10),
              lambda: lenet.get_symbol(num_classes=10)),
    "mlp": (lambda: _mlp(jmx), lambda: _mlp(mx)),
}


@pytest.mark.parametrize("name", sorted(_SYMBOLS))
def test_tojson_string_identical_and_loads_in_both(name, tmp_path):
    make_jax, make_port = _SYMBOLS[name]
    with JNameManager():
        want = make_jax().tojson()
    with NameManager():
        got = make_port()
    assert got.tojson() == want
    # each package reads the other's file back to the same string
    got.save(str(tmp_path / "p.json"))
    assert jmx.sym.load(str(tmp_path / "p.json")).tojson() == want
    back = mx.sym.load_json(want)
    assert back.tojson() == want
    assert back.list_arguments() == got.list_arguments()
    assert back.list_auxiliary_states() == got.list_auxiliary_states()


def test_fixture_convnet_loads_and_matches_jax_forward():
    """tests/fixtures/ref_convnet-symbol.json (legacy ``attr`` keys) and
    ref_convnet-0001.params load in the port; its forward equals the JAX
    package's on the same input."""
    prefix = os.path.join(FIX, "ref_convnet")
    x = np.random.RandomState(0).rand(2, 1, 16, 16).astype(np.float32)
    outs = {}
    for name, pkg in PKGS.items():
        sym, args, auxs = pkg.model.load_checkpoint(prefix, 1)
        mod = pkg.Module(sym, context=pkg.cpu())
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        mod.set_params(args, auxs)
        mod.forward(pkg.io.DataBatch(data=[_nd(pkg, x)]), is_train=False)
        outs[name] = _host(mod.get_outputs()[0])
    assert outs["port"].shape == (2, 10)
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=2e-5,
                               atol=1e-6)


def test_load_json_reads_legacy_param_and_attr_keys():
    js = ('{"nodes": [{"op": "null", "name": "data", "inputs": []}, '
          '{"op": "null", "name": "fc_weight", "attr": {"__lr_mult__": '
          '"0.5"}, "inputs": []}, {"op": "null", "name": "fc_bias", '
          '"inputs": []}, {"op": "FullyConnected", "name": "fc", '
          '"param": {"num_hidden": "3", "no_bias": "False"}, '
          '"inputs": [[0, 0], [1, 0], [2, 0]]}], "arg_nodes": [0, 1, 2], '
          '"heads": [[3, 0]]}')
    got, want = mx.sym.load_json(js), jmx.sym.load_json(js)
    assert got.tojson() == want.tojson()
    assert got.attr_dict()["fc_weight"]["__lr_mult__"] == "0.5"
    assert got.infer_shape(data=(2, 5))[1] == [(2, 3)]
    cf = js.replace('"param": {', '"subgraphs": [{}], "param": {')
    with pytest.raises(mx.MXNetError, match="A.6"):
        mx.sym.load_json(cf)


# ----------------------------------------------------------------------
# Module checkpoint files with optimizer states
# ----------------------------------------------------------------------
def _batch(pkg, seed, n=8):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    return pkg.io.DataBatch(data=[_nd(pkg, x)], label=[_nd(pkg, y)])


def _init_args(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (16, 10)),
            "fc1_bias": rng.uniform(-0.1, 0.1, 16),
            "fc2_weight": rng.uniform(-0.3, 0.3, (4, 16)),
            "fc2_bias": np.zeros(4)}


def _trained_module(pkg, kvstore, steps=3):
    mod = pkg.Module(_mlp(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params={k: _nd(pkg, v.astype(np.float32))
                                for k, v in _init_args().items()})
    mod.init_optimizer(kvstore=pkg.kv.create("device") if kvstore
                       else None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    for i in range(steps):
        mod.fit_step(_batch(pkg, i))
    return mod


def _named_states(mod):
    upd = mod._kvstore._updater if mod._update_on_kvstore else mod._updater
    name_to_live, _ = mod._opt_state_key_maps()
    return {n: _host(upd.states[k]) for n, k in name_to_live.items()
            if k in upd.states}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("kvstore", [False, True], ids=["local", "device"])
def test_module_checkpoint_with_states_crosses_packages(tmp_path, writer,
                                                        reader, kvstore):
    """``save_checkpoint(save_optimizer_states=True)`` by one package,
    ``Module.load(load_optimizer_states=True)`` by the other (under
    the other key scheme too): parameters and momenta equal exactly,
    and the next step agrees at 2e-5 / 1e-6."""
    prefix = str(tmp_path / "m")
    src = _trained_module(PKGS[writer], kvstore)
    src.save_checkpoint(prefix, 3, save_optimizer_states=True)
    with open(prefix + "-0003.states", "rb") as f:
        raw = pickle_compat.load(f) if writer == "port" else None
    if raw is not None:
        assert sorted(raw) == sorted(_init_args())     # keyed by name
    pkg = PKGS[reader]
    dst = pkg.Module.load(prefix, 3, load_optimizer_states=True,
                          context=pkg.cpu())
    dst.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    dst.init_optimizer(kvstore=pkg.kv.create("device") if not kvstore
                       else None, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    got_args = {k: _host(v) for k, v in dst.get_params()[0].items()}
    want_args = {k: _host(v) for k, v in src.get_params()[0].items()}
    for k in want_args:
        np.testing.assert_array_equal(got_args[k], want_args[k])
    got_st, want_st = _named_states(dst), _named_states(src)
    assert sorted(got_st) == sorted(want_st)
    for k in want_st:
        np.testing.assert_array_equal(got_st[k], want_st[k])
    b = 7
    src.fit_step(_batch(PKGS[writer], b))
    dst.fit_step(_batch(pkg, b))
    for k, v in src.get_params()[0].items():
        np.testing.assert_allclose(_host(dst.get_params()[0][k]), _host(v),
                                   rtol=2e-5, atol=1e-6)


def test_module_save_load_params_and_states_reject_unknown_pickles(
        tmp_path):
    mod = _trained_module(mx, False)
    mod.save_params(str(tmp_path / "p.params"))
    other = _trained_module(mx, False, steps=0)
    other.load_params(str(tmp_path / "p.params"))
    for k, v in mod.get_params()[0].items():
        np.testing.assert_array_equal(_host(other.get_params()[0][k]),
                                      _host(v))

    class Evil:
        def __reduce__(self):
            return (os.system, ("true",))
    with open(str(tmp_path / "evil.states"), "wb") as f:
        pickle.dump({"fc1_weight": Evil()}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        mod.load_optimizer_states(str(tmp_path / "evil.states"))


# ----------------------------------------------------------------------
# Gluon files
# ----------------------------------------------------------------------
def _gluon_net(pkg):
    nn = pkg.gluon.nn
    with (JNameManager() if pkg is jmx else NameManager()):
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Dense(8, in_units=6, activation="relu"))
            net.add(nn.BatchNorm(in_channels=8))
            net.add(nn.Dense(3, in_units=8))
    net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
    return net


def _set_weights(pkg, net, seed):
    rng = np.random.RandomState(seed)
    for name, p in sorted(net.collect_params().items()):
        lo = 0.5 if name.endswith("var") else -0.4
        p.set_data(_nd(pkg, rng.uniform(lo, lo + 0.8, p.shape).astype(
            np.float32)))


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_gluon_parameter_files_and_export_cross_packages(tmp_path, writer,
                                                         reader):
    """``save_parameters`` → ``load_parameters`` and ``export`` →
    ``SymbolBlock.imports`` across packages: the reader's forward
    equals the writer's."""
    x = np.random.RandomState(3).rand(4, 6).astype(np.float32)
    src = _gluon_net(PKGS[writer])
    _set_weights(PKGS[writer], src, 5)
    src.hybridize()
    want = _host(src(_nd(PKGS[writer], x)))
    src.save_parameters(str(tmp_path / "net.params"))
    dst = _gluon_net(PKGS[reader])
    dst.load_parameters(str(tmp_path / "net.params"),
                        ctx=PKGS[reader].cpu())
    np.testing.assert_allclose(_host(dst(_nd(PKGS[reader], x))), want,
                               rtol=2e-5, atol=1e-6)
    src.export(str(tmp_path / "exp"), epoch=2)
    block = PKGS[reader].gluon.SymbolBlock.imports(
        str(tmp_path / "exp-symbol.json"), ["data"],
        str(tmp_path / "exp-0002.params"), ctx=PKGS[reader].cpu())
    np.testing.assert_allclose(_host(block(_nd(PKGS[reader], x))), want,
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("kvstore", ["device", None], ids=["store", "local"])
def test_gluon_trainer_states_cross_packages(tmp_path, writer, reader,
                                             kvstore):
    """``Trainer.save_states`` (states and optimizer, with an lr
    schedule part-way) by one package, ``load_states`` by the other:
    momenta, update counts and the schedule's position carry over, and
    the next step agrees at 2e-5 / 1e-6."""
    x = np.random.RandomState(3).rand(4, 6).astype(np.float32)

    def trainer(pkg, net):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        return pkg.gluon.Trainer(net.collect_params(), "sgd",
                                 {"learning_rate": 0.1, "momentum": 0.9,
                                  "lr_scheduler": sched}, kvstore=kvstore)

    def step(pkg, net, tr):
        with pkg.autograd.record():
            loss = (net(_nd(pkg, x)) ** 2).mean()
        loss.backward()
        tr.step(4)

    nets, trs = {}, {}
    for name in (writer, reader):
        pkg = PKGS[name]
        nets[name] = _gluon_net(pkg)
        _set_weights(pkg, nets[name], 5)
        trs[name] = trainer(pkg, nets[name])
    for _ in range(3):
        step(PKGS[writer], nets[writer], trs[writer])
    trs[writer].save_states(str(tmp_path / "t.states"))
    nets[writer].save_parameters(str(tmp_path / "t.params"))
    nets[reader].load_parameters(str(tmp_path / "t.params"),
                                 ctx=PKGS[reader].cpu())
    trs[reader].load_states(str(tmp_path / "t.states"))
    wo, ro = trs[writer]._optimizer, trs[reader]._optimizer
    assert ro.num_update == wo.num_update == 3
    assert ro._index_update_count == wo._index_update_count
    assert ro.lr_scheduler.base_lr == wo.lr_scheduler.base_lr
    assert ro.lr_scheduler._decays_applied \
        == wo.lr_scheduler._decays_applied == 1

    def states(tr):
        upd = tr._kvstore._updater if tr._update_on_kvstore \
            else tr._updaters[0]
        return {k: _host(v) for k, v in upd.states.items()}
    ws, rs = states(trs[writer]), states(trs[reader])
    assert sorted(ws) == sorted(rs)
    for k in ws:
        np.testing.assert_array_equal(rs[k], ws[k])
    for name in (writer, reader):
        step(PKGS[name], nets[name], trs[name])
    for k, p in nets[writer].collect_params().items():
        q = nets[reader].collect_params()[k]
        np.testing.assert_allclose(_host(q.data()), _host(p.data()),
                                   rtol=2e-5, atol=1e-6)
