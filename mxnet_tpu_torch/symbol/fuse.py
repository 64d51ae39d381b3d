"""Graph pass: BatchNorm -> ReLU -> Convolution(1x1) -> _FusedBNReluConv.

Counterpart of ``mxnet_tpu/symbol/fuse.py``, with the same matching
rules, over the port's ``_Node``.  Matched pattern (all conditions
required):

* ``Convolution`` with a 1x1 kernel, stride 1, no padding, no groups,
  ``no_bias=True``, channel-last layout;
* fed by ``Activation(act_type='relu')`` whose output has no other
  consumer;
* fed by ``BatchNorm`` on the channel axis whose primary output has no
  other consumer (and whose mean/var outputs are unused);
* optionally (``fuse_residual=True``), when the convolution's only
  consumer is an elementwise add, the add is folded in as the kernel's
  residual epilogue.

Anything unmatched is left as it is, so the pass is always safe to
apply (an NCHW graph comes back unchanged); the rewritten graph has the
same arguments and auxiliary states, and the same values up to the
order of float sums.
"""
from __future__ import annotations

from ..ops import registry as _reg
from .symbol import Symbol, _Node

__all__ = ["fuse_conv_bn", "count_fused"]

# the port's Symbol ``+`` makes broadcast_add (its only add op so far)
_ADD_OPS = ("broadcast_add",)


def count_fused(symbol):
    """Number of ``_FusedBNReluConv`` nodes in ``symbol`` (the pass
    silently leaves graphs without channel-last 1x1 sites unchanged, so
    callers report this)."""
    return sum(1 for n in symbol._topo()
               if not n.is_var and n.op.name == "_FusedBNReluConv")


def _conv_matches(node):
    if node.is_var or node.op.name != "Convolution":
        return False
    a = node.attrs
    kernel = tuple(a.get("kernel", ()))
    if any(int(k) != 1 for k in kernel) or not kernel:
        return False
    if any(int(s) != 1 for s in tuple(a.get("stride", ()) or ())):
        return False
    if any(int(p) != 0 for p in tuple(a.get("pad", ()) or ())):
        return False
    if int(a.get("num_group", 1)) != 1 or not a.get("no_bias", False):
        return False
    layout = a.get("layout")
    return bool(layout) and str(layout).endswith("C")


def _bn_matches(node, channel_axis):
    if node.is_var or node.op.name != "BatchNorm":
        return False
    a = node.attrs
    if a.get("use_global_stats", False):
        return False
    return int(a.get("axis", 1)) == channel_axis


def fuse_conv_bn(symbol, fuse_residual=True):
    """A new Symbol with every matched BN -> ReLU -> Conv1x1 triple
    replaced by one ``_FusedBNReluConv`` node; ``fuse_residual`` also
    folds a following add into the kernel's epilogue."""
    topo = symbol._topo()
    consumers = {}          # (id(node), out_idx) -> count
    for node in topo:
        for inp, oi in node.inputs:
            consumers[(id(inp), oi)] = consumers.get((id(inp), oi), 0) + 1
    for node, oi in symbol._entries:
        consumers[(id(node), oi)] = consumers.get((id(node), oi), 0) + 1

    fused_op = _reg.get_op("_FusedBNReluConv")

    matches = {}            # conv node id -> (bn node, conv node)
    for node in topo:
        if not _conv_matches(node):
            continue
        act, act_oi = node.inputs[0]
        if act.is_var or act_oi != 0 or act.op.name != "Activation" \
                or act.attrs.get("act_type") != "relu":
            continue
        if consumers.get((id(act), 0), 0) != 1:
            continue
        bn, bn_oi = act.inputs[0]
        if bn_oi != 0 or not _bn_matches(bn, len(node.attrs["kernel"]) + 1):
            continue
        if consumers.get((id(bn), 0), 0) != 1:
            continue
        if any(consumers.get((id(bn), i), 0) for i in range(1, 5)):
            continue
        matches[id(node)] = (bn, node)
    if not matches:
        return symbol

    add_folds = {}          # add node id -> (conv node, residual entry)
    folded = set()
    if fuse_residual:
        for node in topo:
            if node.is_var or node.op.name not in _ADD_OPS:
                continue
            for pos in (0, 1):
                src, oi = node.inputs[pos]
                if oi == 0 and id(src) in matches \
                        and consumers.get((id(src), 0), 0) == 1 \
                        and id(src) not in folded:
                    add_folds[id(node)] = (src, node.inputs[1 - pos])
                    folded.add(id(src))
                    break

    memo = {}

    def fused(conv, residual):
        """The fused node for ``conv``'s match; BatchNorm's eps, momentum
        and fix_gamma (the port keeps every attribute, defaults
        included: 1e-3, 0.9, True)."""
        bn, _ = matches[id(conv)]
        attrs = fused_op.normalize_attrs({
            "num_filter": int(conv.attrs["num_filter"]),
            "eps": bn.attrs.get("eps", 1e-3),
            "momentum": bn.attrs.get("momentum", 0.9),
            "fix_gamma": bn.attrs.get("fix_gamma", True),
            "use_global_stats": False,
            "layout": conv.attrs.get("layout"),
            "with_residual": residual is not None})
        # data, gamma, beta, moving_mean, moving_var, weight (, residual)
        ins = [entry(e) for e in list(bn.inputs) + [conv.inputs[1]]]
        if residual is not None:
            ins.append(entry(residual))
        return _Node(fused_op, conv.name, attrs, ins, given_attrs=attrs)

    def rebuild(node):
        if id(node) not in memo:
            if node.is_var:
                memo[id(node)] = node
            elif id(node) in add_folds:
                memo[id(node)] = fused(*add_folds[id(node)])
            elif id(node) in matches and id(node) not in folded:
                memo[id(node)] = fused(node, None)
            else:
                memo[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                       [entry(e) for e in node.inputs],
                                       node.shape, dict(node.str_attrs),
                                       node.given_attrs)
        return memo[id(node)]

    def entry(e):
        # a replaced node's output 0 is the fused node's output 0; the
        # other outputs of a replaced conv or add do not exist
        node, oi = e
        return (rebuild(node), oi)

    return Symbol([entry(e) for e in symbol._entries])
