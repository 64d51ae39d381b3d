"""The symbolic RNN cell zoo: step cells, their combinators, and the
bridge between the fused op's packed vector and per-gate weights.

Counterpart of ``mxnet_tpu/rnn/rnn_cell.py`` (reference
python/mxnet/rnn/rnn_cell.py): the same classes, the same parameter
names (``{prefix}i2h_weight``, ...), the same op names of an unrolled
graph (``{prefix}t{N}_...``, with ``reset()`` and the step counters as
the JAX package keeps them, so both packages' graphs and checkpoints
carry the same names), cuDNN's gate orders (LSTM i, f, c, o; GRU r, z,
o) and ``FusedRNNCell``'s packed layout, so ``unfuse()``,
``pack_weights`` and ``unpack_weights`` move parameters between the
fused ``sym.RNN`` op and the step cells.  A cell's default
``begin_state`` is batch-1 zeros (``sym.zeros``) that broadcast against
the data inside the graph, as in the JAX package; their gradient sums
over the batch.  ``pack_weights``/``unpack_weights`` take NDArrays or
numpy arrays (``weights.convert_rnn_params`` carries numpy ones).
"""
from __future__ import annotations

import numpy as _np

from .. import initializer as init
from .. import ndarray
from .. import symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]

_FUSED_GATES = {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"], "gru": ["_r", "_z", "_o"]}


def _concat(parts):
    """Concatenate 1-D-compatible pieces along axis 0: numpy arrays into
    a numpy array, NDArrays into an NDArray."""
    if all(isinstance(p, _np.ndarray) for p in parts):
        return _np.concatenate(parts)
    return ndarray.concatenate(parts)


def _seq_to_symbol(steps, axis):
    """[per-step 2D symbols] -> one (.., T, ..) symbol on ``axis``."""
    expanded = [symbol.expand_dims(s, axis=axis) for s in steps]
    return symbol.Concat(*expanded, dim=axis)


def _size(arr):
    return int(_np.prod(arr.shape))


def _symbol_to_seq(seq, axis, length):
    """One stacked symbol -> list of per-step 2D symbols."""
    return list(symbol.split(seq, axis=axis, num_outputs=length,
                             squeeze_axis=1))


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Coerce ``inputs`` between list-of-steps and single-symbol forms
    (reference rnn_cell.py:51 semantics, incl. the merge=None passthrough)."""
    if inputs is None:
        raise ValueError("unroll(inputs=None) is not supported. Create "
                         "input variables outside unroll.")
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, symbol.Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise ValueError(
                    "unroll doesn't allow grouped symbol as input. Convert "
                    "to list with list(inputs) first or let unroll split.")
            inputs = _symbol_to_seq(inputs, in_axis, length)
    else:
        if length is not None and len(inputs) != length:
            raise ValueError(f"len(inputs)={len(inputs)} != length={length}")
        if merge is True:
            inputs = _seq_to_symbol(list(inputs), axis)
            in_axis = axis
    if isinstance(inputs, symbol.Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNParams:
    """Shared Variable container: cells co-owning one RNNParams share
    weights by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        full = self._prefix + name
        if full not in self._params:
            self._params[full] = symbol.Variable(full, **kwargs)
        return self._params[full]


class BaseRNNCell:
    """A recurrence, one step a call: ``cell(step_input, states)`` appends
    one time step to the graph; ``unroll`` loops it; combinators compose
    cells.  Subclasses define ``state_info``, ``_gate_names`` and the step
    itself."""

    def __init__(self, prefix="", params=None):
        self._own_params = params is None
        self._prefix = prefix
        self._params = params if params is not None else RNNParams(prefix)
        self._modified = False
        self.reset()

    # -- bookkeeping ----------------------------------------------------
    def reset(self):
        """Forget step counters so the cell can build a fresh graph."""
        self._init_counter = -1
        self._counter = -1
        for child in getattr(self, "_cells", ()):
            child.reset()

    def _step_name(self):
        """Advance the step counter and return this step's op-name stem."""
        self._counter += 1
        return f"{self._prefix}t{self._counter}_"

    @property
    def params(self):
        self._own_params = False
        return self._params

    # -- state ----------------------------------------------------------
    @property
    def state_info(self):
        raise NotImplementedError()

    @property
    def state_shape(self):
        return [info["shape"] for info in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Starting states (zeros by default; pass ``symbol.Variable`` to
        feed them as graph inputs)."""
        if self._modified:
            raise RuntimeError(
                "After applying modifier cells (e.g. DropoutCell) the base "
                "cell cannot be called directly. Call the modifier cell "
                "instead.")
        states = []
        for info in self.state_info:
            self._init_counter += 1
            call_kwargs = dict(kwargs)
            if info is not None:
                call_kwargs.update(info)
            call_kwargs.pop("__layout__", None)
            if func is not symbol.Variable and "shape" in call_kwargs:
                # The reference writes 0 for the unknown batch dim and lets
                # its bidirectional shape unification resolve it.  Our
                # inference is forward-only, so default states are built
                # batch-1 and broadcast against the data inside the graph
                # (zeros broadcast == zeros of the full batch).
                call_kwargs["shape"] = tuple(
                    d if d else 1 for d in call_kwargs["shape"])
            states.append(func(
                name=f"{self._prefix}begin_state_{self._init_counter}",
                **call_kwargs))
        return states

    def __call__(self, inputs, states):
        raise NotImplementedError()

    # -- packed <-> per-gate weight views -------------------------------
    def unpack_weights(self, args):
        """Split this cell's stacked i2h/h2h weight+bias rows into per-gate
        entries (``{prefix}i2h_i_weight``...); non-gated cells no-op."""
        out = dict(args)
        gates = self._gate_names
        if not gates:
            return out
        h = self._num_hidden
        for group in ("i2h", "h2h"):
            stacked_w = out.pop(f"{self._prefix}{group}_weight")
            stacked_b = out.pop(f"{self._prefix}{group}_bias")
            for row, gate in enumerate(gates):
                out[f"{self._prefix}{group}{gate}_weight"] = \
                    stacked_w[row * h:(row + 1) * h].copy()
                out[f"{self._prefix}{group}{gate}_bias"] = \
                    stacked_b[row * h:(row + 1) * h].copy()
        return out

    def pack_weights(self, args):
        """Inverse of :meth:`unpack_weights`."""
        out = dict(args)
        gates = self._gate_names
        if not gates:
            return out
        for group in ("i2h", "h2h"):
            rows_w, rows_b = [], []
            for gate in gates:
                rows_w.append(out.pop(f"{self._prefix}{group}{gate}_weight"))
                rows_b.append(out.pop(f"{self._prefix}{group}{gate}_bias"))
            out[f"{self._prefix}{group}_weight"] = _concat(rows_w)
            out[f"{self._prefix}{group}_bias"] = _concat(rows_b)
        return out

    # -- unrolling ------------------------------------------------------
    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Build ``length`` chained steps.  Returns (outputs, states);
        ``merge_outputs`` True gives one stacked symbol, False a list,
        None whichever form fell out naturally."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        step_outputs = []
        for t in range(length):
            out, states = self(inputs[t], states)
            step_outputs.append(out)
        outputs, _ = _normalize_sequence(length, step_outputs, layout,
                                         merge_outputs)
        return outputs, states

    @staticmethod
    def _activate(data, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(data, act_type=activation, **kwargs)
        return activation(data, **kwargs)


class _GatedCell(BaseRNNCell):
    """Shared machinery for the three concrete cells: the i2h/h2h
    parameter quad and the fused projection of one step's input+state."""

    def __init__(self, num_hidden, prefix, params, i2h_bias_init=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._hW = self.params.get("h2h_weight")
        self._iB = self.params.get("i2h_bias", **(
            {"init": i2h_bias_init} if i2h_bias_init is not None else {}))
        self._hB = self.params.get("h2h_bias")

    def _project(self, name, inputs, state, width_mult):
        """i2h and h2h FullyConnected for one step."""
        wide = self._num_hidden * width_mult
        i2h = symbol.FullyConnected(data=inputs, weight=self._iW,
                                    bias=self._iB, num_hidden=wide,
                                    name=f"{name}i2h")
        h2h = symbol.FullyConnected(data=state, weight=self._hW,
                                    bias=self._hB, num_hidden=wide,
                                    name=f"{name}h2h")
        return i2h, h2h

    def _single_state_info(self, count):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}
                for _ in range(count)]


class RNNCell(_GatedCell):
    """Elman cell: out = act(W_i x + W_h h + b)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(num_hidden, prefix, params)
        self._activation = activation

    @property
    def state_info(self):
        return self._single_state_info(1)

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._project(name, inputs, states[0], 1)
        output = self._activate(i2h + h2h, self._activation,
                                name=f"{name}out")
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM with cuDNN gate order [i, f, c, o]; ``forget_bias`` seeds the
    forget-gate slice of i2h_bias (Jozefowicz et al. 2015)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(num_hidden, prefix, params,
                         i2h_bias_init=init.LSTMBias(forget_bias=forget_bias))

    @property
    def state_info(self):
        return self._single_state_info(2)

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        name = self._step_name()
        i2h, h2h = self._project(name, inputs, states[0], 4)
        gates = symbol.SliceChannel(i2h + h2h, num_outputs=4,
                                    name=f"{name}slice")
        gate_i = symbol.Activation(gates[0], act_type="sigmoid",
                                   name=f"{name}i")
        gate_f = symbol.Activation(gates[1], act_type="sigmoid",
                                   name=f"{name}f")
        cand = symbol.Activation(gates[2], act_type="tanh",
                                 name=f"{name}c")
        gate_o = symbol.Activation(gates[3], act_type="sigmoid",
                                   name=f"{name}o")
        next_c = symbol._plus(gate_f * states[1], gate_i * cand,
                                        name=f"{name}state")
        next_h = symbol._mul(
            gate_o, symbol.Activation(next_c, act_type="tanh"),
            name=f"{name}out")
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU, cuDNN variant (reset gate applied to the h2h candidate
    projection); gate order [r, z, o]."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(num_hidden, prefix, params)

    @property
    def state_info(self):
        return self._single_state_info(1)

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        name = self._step_name()
        prev = states[0]
        i2h, h2h = self._project(name + "_", inputs, prev, 3)
        i2h_r, i2h_z, i2h_n = symbol.SliceChannel(
            i2h, num_outputs=3, name=f"{name}_i2h_slice")
        h2h_r, h2h_z, h2h_n = symbol.SliceChannel(
            h2h, num_outputs=3, name=f"{name}_h2h_slice")
        reset = symbol.Activation(i2h_r + h2h_r, act_type="sigmoid",
                                  name=f"{name}_r_act")
        update = symbol.Activation(i2h_z + h2h_z, act_type="sigmoid",
                                   name=f"{name}_z_act")
        cand = symbol.Activation(i2h_n + reset * h2h_n, act_type="tanh",
                                 name=f"{name}_h_act")
        next_h = symbol._plus((1. - update) * cand, update * prev,
                                        name=f"{name}out")
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Every layer and step in one op, the fused ``sym.RNN``
    (``ops/rnn.py``); the weights are one packed vector in cuDNN's
    layout (``_fused_segments``)."""

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        super().__init__(prefix=f"{mode}_" if prefix is None else prefix,
                         params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ["l", "r"] if bidirectional else ["l"]
        self._parameter = self.params.get(
            "parameters", init=init.FusedRNN(None, num_hidden, num_layers,
                                             mode, bidirectional,
                                             forget_bias))

    @property
    def state_info(self):
        depth = len(self._directions) * self._num_layers
        arity = 2 if self._mode == "lstm" else 1
        return [{"shape": (depth, 0, self._num_hidden), "__layout__": "LNC"}
                for _ in range(arity)]

    @property
    def _gate_names(self):
        return _FUSED_GATES[self._mode]

    @property
    def _num_gates(self):
        return len(self._gate_names)

    # -- packed layout --------------------------------------------------
    def _fused_segments(self, num_input, h):
        """Yield (param_name, flat_size, view_shape) in packed order: all
        weights layer-major/direction-major (i2h rows per gate, then h2h),
        then all biases in the same order — the cuDNN flat layout."""
        b = len(self._directions)
        for section in ("weight", "bias"):
            for layer in range(self._num_layers):
                width_in = num_input if layer == 0 else b * h
                for d in self._directions:
                    for group, width in (("i2h", width_in), ("h2h", h)):
                        for gate in self._gate_names:
                            name = (f"{self._prefix}{d}{layer}_"
                                    f"{group}{gate}_{section}")
                            if section == "weight":
                                yield name, h * width, (h, width)
                            else:
                                yield name, h, (h,)

    def _slice_weights(self, arr, li, lh):
        """Views of the packed vector, keyed by per-gate param name."""
        views, p = {}, 0
        for name, size, shape in self._fused_segments(li, lh):
            views[name] = arr[p:p + size].reshape(shape)
            p += size
        if p != _size(arr):
            raise ValueError("Invalid parameters size for FusedRNNCell")
        return views

    def _infer_num_input(self, packed_size):
        b, m, h = len(self._directions), self._num_gates, self._num_hidden
        return (packed_size // b // h // m
                - (self._num_layers - 1) * (h + b * h + 2) - h - 2)

    def unpack_weights(self, args):
        out = dict(args)
        packed = out.pop(self._parameter.name)
        views = self._slice_weights(
            packed, self._infer_num_input(_size(packed)), self._num_hidden)
        out.update({name: view.copy() for name, view in views.items()})
        return out

    def pack_weights(self, args):
        out = dict(args)
        first_gate = self._gate_names[0]
        w0 = out[f"{self._prefix}l0_i2h{first_gate}_weight"]
        num_input = w0.shape[1]
        # the flat segments concatenated in packed order
        pieces = [out.pop(name).reshape((-1,))
                  for name, _size, _shape in
                  self._fused_segments(num_input, self._num_hidden)]
        out[self._parameter.name] = _concat(pieces)
        return out

    # -- execution ------------------------------------------------------
    def __call__(self, inputs, states):
        raise NotImplementedError(
            "FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            import warnings
            warnings.warn("NTC layout detected. Consider using TNC for "
                          "FusedRNNCell for faster speed")
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        elif axis != 0:
            raise ValueError(f"Unsupported layout {layout}")
        states = begin_state if begin_state is not None else \
            self.begin_state()
        state_kwargs = {"state": states[0]}
        if self._mode == "lstm":
            state_kwargs["state_cell"] = states[1]
        rnn = symbol.RNN(data=inputs, parameters=self._parameter,
                         state_size=self._num_hidden,
                         num_layers=self._num_layers,
                         bidirectional=self._bidirectional, p=self._dropout,
                         state_outputs=self._get_next_state,
                         mode=self._mode, name=self._prefix + "rnn",
                         **state_kwargs)
        if not self._get_next_state:
            outputs, states = rnn, []
        else:
            n_states = 2 if self._mode == "lstm" else 1
            outputs = rnn[0]
            states = [rnn[1 + i] for i in range(n_states)]
            for s in states:
                s._set_attr(__layout__="LNC")
        if axis == 1:
            outputs = symbol.swapaxes(outputs, dim1=0, dim2=1)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def unfuse(self):
        """Equivalent SequentialRNNCell of step cells, named so that
        ``unpack_weights`` of this fused cell loads it directly."""
        factories = {
            "rnn_relu": lambda pfx: RNNCell(self._num_hidden,
                                            activation="relu", prefix=pfx),
            "rnn_tanh": lambda pfx: RNNCell(self._num_hidden,
                                            activation="tanh", prefix=pfx),
            "lstm": lambda pfx: LSTMCell(self._num_hidden, prefix=pfx),
            "gru": lambda pfx: GRUCell(self._num_hidden, prefix=pfx)}
        make = factories[self._mode]
        stack = SequentialRNNCell()
        for layer in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    make(f"{self._prefix}l{layer}_"),
                    make(f"{self._prefix}r{layer}_"),
                    output_prefix=f"{self._prefix}bi_l{layer}_"))
            else:
                stack.add(make(f"{self._prefix}l{layer}_"))
            if self._dropout > 0 and layer != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f"{self._prefix}_dropout{layer}_"))
        return stack


class _CellGroup(BaseRNNCell):
    """Shared plumbing for combinators holding several child cells."""

    def __init__(self, prefix="", params=None):
        super().__init__(prefix=prefix, params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def _adopt(self, cell):
        """Merge param namespaces (shared-params mode requires the child
        to still own its params, as in the reference)."""
        if self._override_cell_params:
            if not cell._own_params:
                raise ValueError(
                    "Either specify params for the container or child "
                    "cells, not both.")
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)
        self._cells.append(cell)

    @property
    def state_info(self):
        return [info for c in self._cells for info in c.state_info]

    def begin_state(self, **kwargs):
        if self._modified:
            raise RuntimeError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        return [s for c in self._cells for s in c.begin_state(**kwargs)]

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def _split_states(self, states):
        """Carve the flat state list into per-child slices."""
        out, p = [], 0
        for cell in self._cells:
            n = len(cell.state_info)
            out.append(states[p:p + n])
            p += n
        return out


class SequentialRNNCell(_CellGroup):
    """Stack cells vertically: each child consumes the previous child's
    output at every time step."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)

    def add(self, cell):
        self._adopt(cell)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        for cell, sub in zip(self._cells, self._split_states(states)):
            if isinstance(cell, BidirectionalCell):
                raise ValueError("BidirectionalCell cannot be stepped "
                                 "inside SequentialRNNCell")
            inputs, new = cell(inputs, sub)
            next_states.extend(new)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        states = begin_state if begin_state is not None else \
            self.begin_state()
        per_cell = self._split_states(states)
        next_states = []
        last = len(self._cells) - 1
        for i, (cell, sub) in enumerate(zip(self._cells, per_cell)):
            inputs, new = cell.unroll(
                length, inputs=inputs, begin_state=sub, layout=layout,
                merge_outputs=merge_outputs if i == last else None)
            next_states.extend(new)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Stateless dropout applied to the flowing sequence."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        if not isinstance(dropout, (int, float)):
            raise TypeError("dropout probability must be a number")
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(data=inputs, p=self.dropout)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if isinstance(inputs, symbol.Symbol):
            # whole sequence at once: one dropout op covers every step
            return self(inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(BaseRNNCell):
    """Wrap a cell and alter its step behavior; params stay with the base
    cell, which can no longer be called directly."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, init_sym=symbol.zeros, **kwargs):
        if self._modified:
            raise RuntimeError(
                "After applying modifier cells the base cell cannot be "
                "called directly. Call the modifier cell instead.")
        self.base_cell._modified = False
        try:
            return self.base_cell.begin_state(init_sym, **kwargs)
        finally:
            self.base_cell._modified = True

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)

    def __call__(self, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout (Krueger et al.): randomly keep previous outputs/states
    instead of new ones during training."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        if isinstance(base_cell, FusedRNNCell):
            raise TypeError("FusedRNNCell doesn't support zoneout. "
                            "Please unfuse first.")
        if isinstance(base_cell, BidirectionalCell):
            raise TypeError("BidirectionalCell doesn't support zoneout; "
                            "apply ZoneoutCell to the cells underneath.")
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def keep_mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev = self.prev_output if self.prev_output is not None \
            else symbol.zeros((1, 1))
        if self.zoneout_outputs != 0.:
            output = symbol.where(keep_mask(self.zoneout_outputs,
                                            next_output),
                                  next_output, prev)
        else:
            output = next_output
        if self.zoneout_states != 0.:
            next_states = [symbol.where(keep_mask(self.zoneout_states, new),
                                        new, old)
                           for new, old in zip(next_states, states)]
        self.prev_output = output
        return output, next_states


class ResidualCell(ModifierCell):
    """output = base_cell(output) + input (GNMT, Wu et al. 2016)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = symbol.elemwise_add(output, inputs,
                                     name=f"{output.name}_plus_residual")
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        try:
            outputs, states = self.base_cell.unroll(
                length, inputs=inputs, begin_state=begin_state,
                layout=layout, merge_outputs=merge_outputs)
        finally:
            self.base_cell._modified = True
        if merge_outputs is None:
            merge_outputs = isinstance(outputs, symbol.Symbol)
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = symbol.elemwise_add(
                outputs, inputs, name=f"{outputs.name}_plus_residual")
        else:
            outputs = [symbol.elemwise_add(o, i,
                                           name=f"{o.name}_plus_residual")
                       for o, i in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(_CellGroup):
    """Run one cell forward and one backward over the sequence and
    concatenate their per-step outputs on the feature axis."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._output_prefix = output_prefix
        for cell in (l_cell, r_cell):
            self._adopt(cell)

    def __call__(self, inputs, states):
        raise NotImplementedError(
            "Bidirectional cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        states = begin_state if begin_state is not None else \
            self.begin_state()
        l_cell, r_cell = self._cells
        l_state_n = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:l_state_n],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[l_state_n:], layout=layout,
            merge_outputs=merge_outputs)

        if merge_outputs is None:
            merge_outputs = (isinstance(l_outputs, symbol.Symbol)
                             and isinstance(r_outputs, symbol.Symbol))
            if not merge_outputs:
                if isinstance(l_outputs, symbol.Symbol):
                    l_outputs = _symbol_to_seq(l_outputs, axis, length)
                if isinstance(r_outputs, symbol.Symbol):
                    r_outputs = _symbol_to_seq(r_outputs, axis, length)

        if merge_outputs:
            l_seq = [l_outputs]
            r_seq = [symbol.reverse(r_outputs, axis=axis)]
        else:
            l_seq = l_outputs
            r_seq = list(reversed(r_outputs))

        outputs = [symbol.Concat(
            l_o, r_o, dim=1 + merge_outputs,
            name=(f"{self._output_prefix}out" if merge_outputs
                  else f"{self._output_prefix}t{i}"))
            for i, (l_o, r_o) in enumerate(zip(l_seq, r_seq))]
        if merge_outputs:
            outputs = outputs[0]
        return outputs, [l_states, r_states]
