"""PyTorch port: ``mx.name`` and ``mx.config``.

``mx.name.Prefix`` and ``NameManager`` name symbols and Gluon blocks as
the JAX package's name managers do (its ``base.Prefix``, the one its
symbol layer reads: its ``mx.name`` keeps a second stack that names
nothing, ROADMAP C); the port has one stack, so ``mx.name``'s managers
are the ones that name.  ``mx.config.summary()`` lists every variable
the port reads, wired or inert, with the JAX package's columns.
"""
import re

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import base


def _names(pkg, prefix_cls):
    d = pkg.sym.Variable("data")
    with prefix_cls("enc_"):
        a = pkg.sym.FullyConnected(d, num_hidden=3)
        b = pkg.sym.FullyConnected(a, num_hidden=3, name="fc")
        c = pkg.sym.Activation(b, act_type="relu")
        block = pkg.gluon.nn.Dense(2)
    with pkg.name.NameManager() if pkg is mx else jbase.NameManager():
        e = pkg.sym.FullyConnected(d, num_hidden=3)
    return (c.list_arguments(), c.list_outputs(), e.list_outputs(),
            block.prefix, sorted(p.name for p in
                                 block.collect_params().values()))


def test_prefix_names_symbols_and_blocks_as_the_jax_package():
    got = _names(mx, mx.name.Prefix)
    want = _names(jmx, jbase.Prefix)
    assert got == want
    args, outs, scoped, prefix, params = got
    assert args == ["data", "enc_fullyconnected0_weight",
                    "enc_fullyconnected0_bias", "enc_fc_weight",
                    "enc_fc_bias"]
    assert outs == ["enc_activation0_output"]
    assert scoped == ["fullyconnected0_output"]
    assert prefix.startswith("enc_dense")


def test_one_stack():
    """``mx.name``'s managers are ``base``'s: ``current()`` is the
    innermost scope the symbol layer reads."""
    assert mx.name.NameManager is base.NameManager
    assert mx.name.Prefix is base.Prefix
    with mx.name.Prefix("p_") as p:
        assert mx.name.current() is p is base.current_name_manager()
        with mx.name.NameManager() as q:
            assert mx.name.current() is q
        assert mx.name.current() is p
    assert mx.name.current() is base.NAMES


def test_jax_name_module_keeps_a_second_stack():
    """The reference-side fact the port does not copy: the JAX
    package's ``mx.name.Prefix`` does not reach its symbols."""
    d = jmx.sym.Variable("data")
    with jmx.name.Prefix("enc_"):
        a = jmx.sym.FullyConnected(d, num_hidden=3, name="fc")
    assert a.list_outputs() == ["fc_output"]


def _table(text):
    rows = text.splitlines()
    assert re.split(r"\s+", rows[0].strip())[:4] == ["Variable", "Value",
                                                       "Wired", "Notes"]
    out = {}
    for r in rows[1:]:
        name, value, wired = re.split(r"\s+", r.strip())[:3]
        out[name] = (value, wired)
    return out


def test_summary_lists_what_the_port_reads(monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    monkeypatch.delenv("MXNET_FIT_FUSED", raising=False)
    rows = _table(mx.config.summary())
    assert rows["MXNET_BACKWARD_DO_MIRROR"] == ("1", "yes")
    assert rows["MXNET_FIT_FUSED"] == ("1", "yes")
    for name in ("MXNET_KVSTORE_FUSED", "MXNET_DECODE_DONATE",
                 "MXNET_DECODE_SPEC_K", "MXNET_LOSS_SCALE",
                 "MXNET_LOSS_SCALE_INIT", "MXNET_CHECKPOINT_EVERY",
                 "MXNET_CHECKPOINT_PREFIX"):
        assert rows[name][1] == "yes", name
    assert rows["MXNET_ENGINE_TYPE"][1] == "inert"
    # the columns of the JAX package's table
    jrows = _table(jmx.config.summary())
    assert set(jrows) & set(rows) >= {"MXNET_BACKWARD_DO_MIRROR",
                                      "MXNET_ENGINE_TYPE"}


def test_every_variable_the_port_reads_is_listed():
    """Each ``MXNET_*`` name read through ``os.environ`` anywhere in the
    port is in the table."""
    import pathlib
    root = pathlib.Path(mx.__file__).parent
    read = set()
    for f in root.rglob("*.py"):
        read |= set(re.findall(r'"(MXNET_[A-Z0-9_]+)"', f.read_text()))
    listed = set(mx.config._KNOWN)
    assert read <= listed, sorted(read - listed)


@pytest.mark.parametrize("value,want", [("1", True), ("true", True),
                                        ("True", True), ("0", False),
                                        ("", False)])
def test_backward_do_mirror_and_env_bool(monkeypatch, value, want):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", value)
    assert mx.config.backward_do_mirror() is want
    assert jmx.config.backward_do_mirror() is want
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert mx.config.naive_engine() and jmx.config.naive_engine()
