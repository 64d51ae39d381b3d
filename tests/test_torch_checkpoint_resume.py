"""Full-state resume through ``mx.checkpoint`` (ROADMAP A.7).

A run killed after tag k and resumed in a fresh ``Module`` ends bit for
bit where the uninterrupted run ends, in the port (fused and eager,
dense and 2-bit, f32 and bf16 with the loss scaler), in the pattern of
tests/test_checkpoint_resume.py; a checkpoint of either package
restores in the other with the state equal exactly and the continued
steps within 2e-5 / 1e-6; the ``CheckpointManager`` contracts of
tests/test_checkpoint_async.py (rotation, fallback past corruption,
retry, a snapshot training cannot touch, SIGTERM, the callbacks); and
``DecodeEngine.reload`` against the JAX engine's reload of the same
files (the JAX engine's paged kernels in interpret mode).
"""
import os
import signal

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import checkpoint as jcheckpoint
from mxnet_tpu.decode import DecodeEngine as JaxEngine

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint
from mxnet_tpu_torch.checkpoint import manifest as mf
from mxnet_tpu_torch.checkpoint import writer as ckw
from mxnet_tpu_torch.decode import DecodeEngine
from mxnet_tpu_torch.weights import convert_params, param_shapes

PKGS = {"jax": jmx, "port": mx}
_ENV = ("MXNET_FIT_FUSED", "MXNET_LOSS_SCALE", "MXNET_CHECKPOINT_EVERY",
        "MXNET_CHECKPOINT_PREFIX")


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def _nd(pkg, a):
    return jmx.nd.array(a) if pkg is jmx else mx.nd.array(a, ctx=mx.cpu())


def _host(x):
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "_data") and isinstance(x._data, torch.Tensor):
        return _host(x._data)
    a = np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _mlp(pkg, bf16):
    s = pkg.sym
    data = s.Variable("data")
    if bf16:
        data = s.Cast(data, dtype="bfloat16")
    h = s.FullyConnected(data, num_hidden=16, name="fc1")
    h = s.Activation(h, act_type="relu")
    h = s.FullyConnected(h, num_hidden=4, name="fc2")
    if bf16:
        h = s.Cast(h, dtype="float32")
    return s.SoftmaxOutput(h, name="softmax")


def _init_args():
    rng = np.random.RandomState(1)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (16, 10)),
            "fc1_bias": rng.uniform(-0.1, 0.1, 16),
            "fc2_weight": rng.uniform(-0.3, 0.3, (4, 16)),
            "fc2_bias": np.zeros(4)}


def _batch(pkg, seed, n=8):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 10)).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.float32)
    return pkg.io.DataBatch(data=[_nd(pkg, x)], label=[_nd(pkg, y)])


def _make_mod(pkg, fused=True, compress=None, bf16=False, kvstore=True,
              sched=False):
    mod = pkg.Module(_mlp(pkg, bf16), context=pkg.cpu(),
                     compression_params={"type": "2bit",
                                         "threshold": compress}
                     if compress else None)
    mod._fused_fit_enabled = fused
    mod.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(arg_params={k: _nd(pkg, v.astype(np.float32))
                                for k, v in _init_args().items()})
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
              "multi_precision": bf16}
    if sched:
        params["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(
            step=2, factor=0.7)
    mod.init_optimizer(kvstore=pkg.kv.create("device") if kvstore else None,
                       optimizer="sgd", optimizer_params=params)
    return mod


def _leaves(state):
    if isinstance(state, tuple):
        return [x for s in state for x in _leaves(s)]
    return [] if state is None else [state]


def _params(mod):
    return {k: _host(v) for k, v in mod.get_params()[0].items()}


def _run(pkg, mod, first, n):
    for i in range(first, first + n):
        mod.fit_step(_batch(pkg, i))


# ----------------------------------------------------------------------
# resume in the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "eager"])
@pytest.mark.parametrize("compress", [None, 0.05], ids=["dense", "2bit"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_resume_is_bit_identical(tmp_path, fused, compress, bf16):
    """Kill after tag 3, resume a fresh Module from it: the 3 steps that
    follow end bit-equal to the uninterrupted run (weights, masters,
    momenta, residuals, the fused step's scaler).  A restore without
    the optimizer states does not, as the control arm shows."""
    prefix = str(tmp_path / "ck")
    a = _make_mod(mx, fused, compress, bf16)
    mgr = checkpoint.CheckpointManager(prefix, module=a, keep=0,
                                       install_preemption=False)
    _run(mx, a, 0, 3)
    mgr.save(epoch=0, step=3)
    mgr.drain()
    _run(mx, a, 3, 3)
    mgr.close()
    want = checkpoint.capture(a)
    b = _make_mod(mx, fused, compress, bf16)
    man = checkpoint.restore(b, prefix)
    assert man["tag"] == 3 and man["step"] == 3 and man["epoch"] == 0
    _run(mx, b, 3, 3)
    got = checkpoint.capture(b)
    assert (a._fused_fit is not None) == fused
    for part in ("args", "auxs"):
        for k in want[part]:
            assert torch.equal(got[part][k], want[part][k]), k
    for k, st in want["states"].items():
        for x, y in zip(_leaves(got["states"][k]),
                        _leaves(st)):
            assert torch.equal(x, y), k
    if compress:
        res = want["extra"]["residuals"]
        assert res and any(bool(v.abs().sum()) for v in res.values())
        for k, v in res.items():
            assert torch.equal(got["extra"]["residuals"][k], v), k
    if bf16:
        if fused:
            assert got["extra"]["loss_scaler"] \
                == want["extra"]["loss_scaler"]
        assert b.get_params()[0]["fc1_weight"].dtype == torch.bfloat16
    # control: a restore without the optimizer states diverges
    c = _make_mod(mx, fused, compress, bf16)
    checkpoint.restore(c, prefix, load_optimizer=False)
    _run(mx, c, 3, 3)
    assert any(not np.array_equal(v, _params(a)[k])
               for k, v in _params(c).items())


def test_restore_into_live_captured_step_keeps_its_tensors(tmp_path):
    """A restore into a module whose fused step is live writes the
    weights, states and residuals in place: the step keeps its program
    (no new trace) and the restored run matches a fresh restore."""
    from mxnet_tpu_torch.module import fused_fit
    prefix = str(tmp_path / "live")
    a = _make_mod(mx, True, 0.05)
    _run(mx, a, 0, 2)
    checkpoint.CheckpointManager(prefix, module=a, keep=0,
                                 install_preemption=False).save(
        step=2, block=True)
    _run(mx, a, 2, 3)
    traces, ids = fused_fit.TRACE_COUNT, a._fused_fit._bound
    checkpoint.restore(a, prefix)
    _run(mx, a, 2, 2)
    assert fused_fit.TRACE_COUNT == traces and a._fused_fit._bound == ids
    b = _make_mod(mx, True, 0.05)
    checkpoint.restore(b, prefix)
    _run(mx, b, 2, 2)
    for k, v in _params(b).items():
        np.testing.assert_array_equal(_params(a)[k], v)


# ----------------------------------------------------------------------
# across packages
# ----------------------------------------------------------------------
def _state_numpy(pkg, mod):
    """The captured state of either package as numpy, name-keyed."""
    st = (jcheckpoint if pkg is jmx else checkpoint).capture(mod)
    ex = st["extra"]
    sched = ex["lr_scheduler"]
    return {"args": {k: _host(v) for k, v in st["args"].items()},
            "auxs": {k: _host(v) for k, v in st["auxs"].items()},
            "states": {k: _host(v) for k, v in st["states"].items()},
            "counts": ex["index_update_count"],
            "num_update": ex["num_update"],
            "sched": None if sched is None else dict(vars(sched)),
            "residuals": {k: _host(v) for k, v in
                          (ex.get("residuals") or {}).items()},
            "scaler": {k: ex["loss_scaler"][k] for k in ("scale", "good",
                                                         "skips")}
            if ex.get("loss_scaler") else None,
            "host_rng": ex["host_rng"]}


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _equal(a[k], b[k], "%s/%s" % (path, k))
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
@pytest.mark.parametrize("case", ["dense-local", "2bit", "bf16-2bit"])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader,
                                             case):
    """One package trains 3 steps (an lr schedule part-way, 2-bit
    residuals, the bf16 scaler) and checkpoints; the other restores
    into a fresh module: parameters, name-keyed states, update counts,
    the schedule's position, residuals, the scaler triple, the host
    random stream, epoch and step equal exactly.  In f32 the next 2
    steps of both agree at 2e-5 / 1e-6."""
    bf16 = case.startswith("bf16")
    compress = 0.05 if "2bit" in case else None
    kvstore = case != "dense-local"
    prefix = str(tmp_path / "x")
    kw = dict(compress=compress, bf16=bf16, kvstore=kvstore, sched=True)
    wp, rp = PKGS[writer], PKGS[reader]
    wp.random.seed(3)
    src = _make_mod(wp, **kw)
    _run(wp, src, 0, 3)
    mgr = (jcheckpoint if wp is jmx else checkpoint).CheckpointManager(
        prefix, module=src, keep=0, install_preemption=False)
    mgr.save(epoch=1, step=3, block=True)
    mgr.close()
    want = _state_numpy(wp, src)
    dst = _make_mod(rp, **kw)
    man = (jcheckpoint if rp is jmx else checkpoint).restore(dst, prefix)
    assert (man["epoch"], man["step"], man["tag"]) == (1, 3, 3)
    got = _state_numpy(rp, dst)
    assert want["residuals"] if compress else not want["residuals"]
    assert (want["scaler"] is not None) == bf16
    _equal(got, want)
    if bf16:
        return
    _run(wp, src, 3, 2)
    _run(rp, dst, 3, 2)
    for k, v in _params(src).items():
        np.testing.assert_allclose(_params(dst)[k], v, rtol=2e-5, atol=1e-6)


# ----------------------------------------------------------------------
# CheckpointManager contracts
# ----------------------------------------------------------------------
def test_latest_falls_back_past_corruption(tmp_path):
    prefix = str(tmp_path / "ck")
    mod = _make_mod(mx, compress=0.05)
    mgr = checkpoint.CheckpointManager(prefix, module=mod, keep=0,
                                       install_preemption=False)
    for step in (1, 2, 3, 4):
        _run(mx, mod, step, 1)
        mgr.save(step=step, block=True)
    mgr.close()
    with open(prefix + "-0004.params", "r+b") as f:
        f.truncate(64)                     # crash mid-write
    with open(prefix + "-0003.params", "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))      # bit rot, size unchanged
    with open(mf.manifest_path(prefix, 2), "w") as f:
        f.write('{"format": 1, "files": {"par')    # torn manifest
    assert checkpoint.latest(prefix)["tag"] == 1
    assert checkpoint.restore(_make_mod(mx, compress=0.05),
                              prefix)["tag"] == 1
    with pytest.raises(IOError):
        checkpoint.load(prefix, tag=4)


def test_keep_n_rotation_and_tags_continue(tmp_path):
    prefix = str(tmp_path / "ck")
    mod = _make_mod(mx)
    mgr = checkpoint.CheckpointManager(prefix, module=mod, keep=2,
                                       install_preemption=False)
    for step in (1, 2, 3, 4, 5):
        _run(mx, mod, step, 1)
        mgr.save(step=step, block=True)
    mgr.close()
    assert mf.list_tags(prefix) == [4, 5]
    assert not [f for f in os.listdir(str(tmp_path))
                if any("-000%d." % t in f for t in (1, 2, 3))]
    assert os.path.exists(prefix + "-symbol.json")
    again = checkpoint.CheckpointManager(prefix, module=mod, keep=0,
                                         install_preemption=False)
    again.save(block=True)                 # an explicit save: tag 6
    again.close()
    assert mf.list_tags(prefix) == [4, 5, 6]


def test_async_write_retry_with_backoff(tmp_path, monkeypatch):
    prefix = str(tmp_path / "rt")
    failures = ckw.FAILURES
    f0 = failures.value
    orig, flaked = os.replace, []

    def flaky(src, dst):
        if not flaked and dst.endswith(".params"):
            flaked.append(dst)
            raise OSError("transient blip")
        return orig(src, dst)

    monkeypatch.setattr(os, "replace", flaky)
    man = checkpoint.save(prefix, 1, {"w": np.ones(3, np.float32)}, {},
                          retries=3, backoff=0.001)
    assert man["tag"] == 1 and flaked and failures.value == f0
    assert checkpoint.latest(prefix)["tag"] == 1

    def down(src, dst):
        raise OSError("disk gone")

    monkeypatch.setattr(os, "replace", down)
    with pytest.raises(OSError):
        checkpoint.save(prefix, 2, {"w": np.ones(3, np.float32)}, {},
                        retries=1, backoff=0.001)
    assert failures.value == f0 + 1


def test_async_snapshot_immune_to_continued_training(tmp_path):
    """The writer serializes what the step boundary held, whatever the
    training does meanwhile: the committed tag equals a synchronous
    capture taken at the same boundary."""
    prefix = str(tmp_path / "imm")
    mod = _make_mod(mx, compress=0.05)
    _run(mx, mod, 0, 2)
    want = {k: v.clone() for k, v in checkpoint.capture(mod)["args"].items()}
    mgr = checkpoint.CheckpointManager(prefix, module=mod, keep=0,
                                       install_preemption=False)
    gate = mgr._writer
    mgr.save(step=2)
    _run(mx, mod, 2, 4)                    # training goes on
    assert gate.drain(30)
    mgr.close()
    _, args, _, _ = checkpoint.load(prefix, 2)
    for k, v in want.items():
        assert torch.equal(args[k]._data, v), k
    assert ckw.BLOCK_MS.count > 0


def _fit_data(n=64):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 10).astype(np.float32),
            rng.randint(0, 4, n).astype(np.float32))


def test_sigterm_triggers_emergency_save(tmp_path):
    prefix = str(tmp_path / "term")
    X, y = _fit_data()
    mod = mx.Module(_mlp(mx, False), context=mx.cpu())
    prev = signal.getsignal(signal.SIGTERM)
    sent = []

    def bomb(param):
        if param.nbatch == 2 and not sent:
            sent.append(1)
            os.kill(os.getpid(), signal.SIGTERM)

    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=50,
            optimizer="sgd", optimizer_params={"learning_rate": 0.05},
            batch_end_callback=bomb, checkpoint_every=1000,
            checkpoint_prefix=prefix)
    assert sent
    man = checkpoint.latest(prefix)
    assert man is not None and man["step"] == 3
    assert mf.list_tags(prefix) == [3]
    assert signal.getsignal(signal.SIGTERM) is prev
    res = _make_mod(mx, kvstore=False)
    checkpoint.restore(res, prefix)
    _run(mx, res, 0, 1)


def test_do_checkpoint_and_module_checkpoint_callbacks(tmp_path):
    """``do_checkpoint`` (in place and async) keeps the epoch-numbered
    files; ``module_checkpoint(async_write=True)`` commits the full
    state, which ``Module.load`` and the JAX package read."""
    X, y = _fit_data(32)
    prefix = str(tmp_path / "cb")
    mod = mx.Module(_mlp(mx, False), context=mx.cpu())
    cbs = [mx.callback.do_checkpoint(prefix + "a"),
           mx.callback.do_checkpoint(prefix + "b", async_write=True),
           mx.callback.module_checkpoint(mod, prefix + "c",
                                         save_optimizer_states=True,
                                         async_write=True)]
    mod.fit(mx.io.NDArrayIter(X, y, batch_size=8), num_epoch=2,
            optimizer="sgd", optimizer_params={"momentum": 0.9},
            epoch_end_callback=cbs)
    for cb in cbs:
        assert cb.drain(30)
        cb.close()
    want = _params(mod)
    for p in ("a", "b", "c"):
        _, args, _ = mx.model.load_checkpoint(prefix + p, 2)
        _, jargs, _ = jmx.model.load_checkpoint(prefix + p, 2)
        for k, v in want.items():
            np.testing.assert_array_equal(_host(args[k]), v)
            np.testing.assert_array_equal(_host(jargs[k]), v)
    assert checkpoint.latest(prefix + "b")["tag"] == 2
    man = checkpoint.latest(prefix + "c")
    assert man["tag"] == 2 and "states" in man["files"]
    loaded = mx.Module.load(prefix + "c", 2, load_optimizer_states=True,
                            context=mx.cpu())
    loaded.bind(data_shapes=[("data", (8, 10))],
                label_shapes=[("softmax_label", (8,))])
    loaded.init_optimizer(optimizer="sgd",
                          optimizer_params={"momentum": 0.9})
    assert sorted(loaded._updater.states) == [0, 1, 2, 3]


def test_random_state_roundtrip_and_sharded_raises():
    mx.random.seed(5)
    st = mx.random.get_state()
    a = mx.random.host_rng().rand(3)
    t = torch.rand(3, generator=mx.random.generator("cpu"))
    mx.random.set_state(st)
    np.testing.assert_array_equal(mx.random.host_rng().rand(3), a)
    assert torch.equal(torch.rand(3, generator=mx.random.generator("cpu")),
                       t)
    with pytest.raises(mx.MXNetError, match="A.8"):
        checkpoint.save_sharded("x", 1)


# ----------------------------------------------------------------------
# DecodeEngine.reload
# ----------------------------------------------------------------------
_CFG = dict(num_classes=50, num_layers=2, d_model=16, num_heads=2,
            seq_len=48)
_ENGINE = dict(capacity=3, block_size=4, num_blocks=36, chunk_tokens=8)


def test_decode_engine_reload_matches_jax_engine(tmp_path, monkeypatch):
    """Both engines start from one set of weights and ``reload`` another
    from the same checkpoint (a tag through the manifest, then an epoch
    file): greedy streams equal token for token, and equal a fresh
    engine built with the reloaded weights."""
    monkeypatch.setenv("MXNET_PAGED_ATTN_IMPL", "pallas")
    rng = np.random.RandomState(7)
    old, new = ({n: rng.normal(0, 0.1, s).astype(np.float32)
                 for n, s in param_shapes(_CFG).items()} for _ in range(2))
    prefix = str(tmp_path / "lm")
    checkpoint.save(prefix, 5, {k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in new.items()}, {})
    mx.model.save_checkpoint(prefix, 9, None,
                             {k: mx.nd.array(v, ctx=mx.cpu())
                              for k, v in old.items()}, {})
    prompts = [list(rng.randint(1, 50, n)) for n in (5, 9, 3)]
    streams = {}
    engines = {"jax": JaxEngine(old, _CFG, **_ENGINE),
               "port": DecodeEngine(convert_params(old, mx.cpu(), _CFG),
                                    _CFG, ctx=mx.cpu(), **_ENGINE)}
    try:
        for name, eng in engines.items():
            assert eng.reload(prefix) == 5
            first = [eng.generate(p, max_new_tokens=6, timeout=300)
                     for p in prompts]
            assert eng.reload(prefix, epoch=9) == 9
            second = [eng.generate(p, max_new_tokens=6, timeout=300)
                      for p in prompts]
            streams[name] = (first, second)
            assert eng.stats()["model_version"] == 9
    finally:
        for eng in engines.values():
            eng.stop()
    assert streams["port"] == streams["jax"]
    fresh = DecodeEngine(convert_params(new, mx.cpu(), _CFG), _CFG,
                         ctx=mx.cpu(), **_ENGINE)
    try:
        assert [fresh.generate(p, max_new_tokens=6, timeout=300)
                for p in prompts] == streams["port"][0]
    finally:
        fresh.stop()
    with pytest.raises(mx.MXNetError, match="decode reload"):
        engines["port"].reload(str(tmp_path / "missing"))
